"""Process supervision for the serving plane (DESIGN.md §9).  Port of
``repro.serve.supervise``: the standard library only, no card.

The sharded plane (``launch/cluster_serve.py``) is a tree of OS
processes — shard writers and shm replica readers — and the paper's
distributed setting makes worker death *normal*, not exceptional.  This
module is the part of the Hadoop-era framework contract the hand-rolled
plane was missing: a :class:`Supervisor` owns a set of named children,
restarts one when it dies (capped exponential backoff between
attempts), and gives up on a crash-looping child after ``max_restarts``
exits inside ``restart_window`` seconds (state ``failed`` — restarting
a deterministically-crashing writer forever would just burn CPU while
the router's degraded path already covers the range).

Children are described by a *factory*: a callable returning a
**started** ``multiprocessing.Process``.  The factory re-runs on every
restart, so a writer factory that points at a ``recover_dir`` gets the
checkpoint+WAL recovery path (``serve.service.TriclusterService``) for
free — restart *is* recovery.

Two restart triggers:

* **exit** — the child process died.  Exit codes in ``clean_exits``
  (default: 0) mark a deliberate stop and are not restarted.
* **restart flag** — a file named ``{name}.restart`` appearing in
  ``flag_dir``.  This is the cross-process escalation path for *hung*
  children: a replica whose stuck-odd protocol declares its writer dead
  (``serve.shm.WriterDeadError``) cannot kill the writer itself — it
  drops a flag file and the supervisor terminates + relaunches the
  writer.  Flag files are consumed (unlinked) exactly once.

Everything is driven by one monitor thread polling at
``poll_interval``; all state transitions are recorded in an ``events``
list (name, event, detail tuples) so fault-injection tests can assert
exact restart sequences instead of sleeping and hoping.  The log is a
*bounded tail*: past ``max_events`` entries it rotates atomically (a
fresh list is bound in one assignment, led by a ``rotated`` marker
carrying the cumulative drop count), so a long-running plane cannot
leak memory through its own audit trail while readers holding the old
reference still see a consistent list.

Children can also *push* events into the log across the process
boundary: :func:`write_event` appends JSON lines to
``{flag_dir}/{name}.events``, which the monitor ingests (atomic
rename + read) on every tick — the path the data-integrity plane uses
to surface WAL/checkpoint quarantines (``serve.service``) in the same
timeline as the restarts they explain.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple


class _Child:
    __slots__ = ("name", "factory", "proc", "state", "restarts",
                 "exit_times", "backoff", "next_restart_at",
                 "started_at", "last_exit", "clean_exits")

    def __init__(self, name: str, factory, clean_exits: Sequence[int]):
        self.name = name
        self.factory = factory
        self.proc = None
        self.state = "new"        # new|running|backoff|failed|stopped
        self.restarts = 0
        self.exit_times: List[float] = []
        self.backoff = 0.0
        self.next_restart_at = 0.0
        self.started_at = 0.0
        self.last_exit: Optional[int] = None
        self.clean_exits = tuple(int(c) for c in clean_exits)


class Supervisor:
    """Restart-with-backoff supervision over named child processes."""

    def __init__(self, restart_backoff: float = 0.2,
                 backoff_max: float = 5.0, max_restarts: int = 5,
                 restart_window: float = 60.0,
                 flag_dir: Optional[str] = None,
                 poll_interval: float = 0.05,
                 max_events: int = 2048):
        self.restart_backoff = float(restart_backoff)
        self.backoff_max = float(backoff_max)
        self.max_restarts = int(max_restarts)
        self.restart_window = float(restart_window)
        self.flag_dir = flag_dir
        self.poll_interval = float(poll_interval)
        self.max_events = max(8, int(max_events))
        self._children: Dict[str, _Child] = {}
        self._lock = threading.RLock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: (name, event, detail) transition log — the deterministic
        #: assertion surface for chaos tests.  Bounded: rotates to the
        #: newest half past ``max_events`` (see :meth:`_event`)
        self.events: List[Tuple[str, str, str]] = []
        #: total entries dropped by rotation so far
        self.events_dropped = 0

    # -- registration / lifecycle --------------------------------------------

    def add(self, name: str, factory: Callable,
            clean_exits: Sequence[int] = (0,)) -> "Supervisor":
        """Register (and immediately launch) child ``name``.
        ``factory()`` must return a *started* ``multiprocessing``
        process; it re-runs on every restart."""
        with self._lock:
            if name in self._children:
                raise ValueError(f"duplicate child {name!r}")
            ch = _Child(name, factory, clean_exits)
            self._children[name] = ch
            self._launch(ch)
        return self

    def _event(self, name: str, event: str, detail: str = "") -> None:
        with self._lock:
            ev = self.events
            ev.append((name, event, detail))
            if len(ev) > self.max_events:
                keep = self.max_events // 2
                self.events_dropped += len(ev) - keep
                # atomic rotation: bind a *new* list in one assignment —
                # readers holding the old reference keep a consistent
                # (if stale) view, and the tail they care about survives
                self.events = [("<supervisor>", "rotated",
                                f"dropped {self.events_dropped} older "
                                f"events")] + ev[-keep:]

    def _launch(self, ch: _Child) -> None:
        ch.proc = ch.factory()
        ch.state = "running"
        ch.started_at = time.monotonic()
        self._event(ch.name, "started", f"pid={ch.proc.pid}")

    def start(self) -> "Supervisor":
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._monitor,
                                        name="supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self, terminate: bool = True, join_timeout: float = 10.0
             ) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            self._thread = None
        if not terminate:
            return
        with self._lock:
            for ch in self._children.values():
                p = ch.proc
                if p is not None and p.is_alive():
                    p.terminate()
                ch.state = "stopped"
        with self._lock:
            procs = [ch.proc for ch in self._children.values()
                     if ch.proc is not None]
        for p in procs:
            p.join(timeout=join_timeout)

    def __enter__(self) -> "Supervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- monitoring ----------------------------------------------------------

    def _flag_path(self, name: str) -> Optional[str]:
        if self.flag_dir is None:
            return None
        return os.path.join(self.flag_dir, f"{name}.restart")

    def _consume_flag(self, name: str) -> bool:
        path = self._flag_path(name)
        if path is None:
            return False
        try:
            os.unlink(path)                  # consume exactly once
            return True
        except FileNotFoundError:
            return False

    def _schedule_restart(self, ch: _Child, reason: str) -> None:
        now = time.monotonic()
        ch.exit_times.append(now)
        cutoff = now - self.restart_window
        ch.exit_times = [t for t in ch.exit_times if t >= cutoff]
        if len(ch.exit_times) > self.max_restarts:
            ch.state = "failed"
            self._event(ch.name, "failed",
                        f"{len(ch.exit_times)} exits in "
                        f"{self.restart_window:.0f}s ({reason})")
            return
        # a child that ran for a while before dying earns a fresh
        # backoff; a quick death doubles the previous one
        if ch.started_at and now - ch.started_at > 2 * self.backoff_max:
            ch.backoff = 0.0
        ch.backoff = (self.restart_backoff if ch.backoff == 0.0
                      else min(ch.backoff * 2, self.backoff_max))
        ch.next_restart_at = now + ch.backoff
        ch.state = "backoff"
        self._event(ch.name, "backoff",
                    f"{reason}; retry in {ch.backoff:.2f}s")

    def _tick(self) -> None:
        with self._lock:
            for ch in self._children.values():
                if ch.state == "running":
                    if self._consume_flag(ch.name):
                        # hung-child escalation: terminate + relaunch
                        self._event(ch.name, "flagged", "restart flag")
                        p = ch.proc
                        if p is not None and p.is_alive():
                            p.terminate()
                            p.join(timeout=10)
                        ch.restarts += 1
                        ch.last_exit = (None if p is None
                                        else p.exitcode)
                        self._schedule_restart(ch, "restart flag")
                    elif not ch.proc.is_alive():
                        ch.proc.join()
                        ch.last_exit = ch.proc.exitcode
                        if ch.last_exit in ch.clean_exits:
                            ch.state = "stopped"
                            self._event(ch.name, "stopped",
                                        f"exit={ch.last_exit}")
                        else:
                            ch.restarts += 1
                            self._schedule_restart(
                                ch, f"exit={ch.last_exit}")
                elif ch.state == "backoff" and \
                        time.monotonic() >= ch.next_restart_at:
                    self._event(ch.name, "restarting",
                                f"attempt {ch.restarts}")
                    self._launch(ch)
        self._ingest_child_events()

    def _ingest_child_events(self) -> None:
        """Adopt events pushed by children via :func:`write_event` into
        the supervisor's log.  The file is claimed by atomic rename
        first, so a child appending concurrently either lands in this
        batch or in a fresh file for the next tick — never lost."""
        if self.flag_dir is None:
            return
        with self._lock:
            names = list(self._children)
        for name in names:
            path = os.path.join(self.flag_dir, f"{name}.events")
            claimed = f"{path}.ingest"
            try:
                os.replace(path, claimed)
            except OSError:
                continue
            try:
                with open(claimed, encoding="utf-8") as fh:
                    data = fh.read()
            finally:
                try:
                    os.unlink(claimed)
                except OSError:
                    pass
            for line in data.splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except json.JSONDecodeError:
                    doc = {"event": "child_event", "detail": line}
                self._event(name, str(doc.get("event", "child_event")),
                            str(doc.get("detail", "")))

    def _monitor(self) -> None:
        while not self._stop_evt.wait(self.poll_interval):
            try:
                self._tick()
            except Exception as e:           # noqa: BLE001 — the
                # supervisor itself must not die of a child race
                self._event("<supervisor>", "tick_error", repr(e))

    # -- introspection -------------------------------------------------------

    def restart(self, name: str) -> None:
        """Manual restart request — same path as a flag file."""
        with self._lock:
            ch = self._children[name]
            p = ch.proc
            if p is not None and p.is_alive():
                p.terminate()
                p.join(timeout=10)
            ch.restarts += 1
            self._schedule_restart(ch, "manual restart")

    def child_state(self, name: str) -> str:
        with self._lock:
            return self._children[name].state

    def wait_state(self, name: str, states: Sequence[str],
                   timeout: float = 30.0) -> str:
        """Block until child ``name`` reaches one of ``states`` —
        event-driven test synchronisation (no sleeps-as-sync)."""
        deadline = time.monotonic() + timeout
        while True:
            st = self.child_state(name)
            if st in states:
                return st
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{name}: state {st!r} after {timeout}s "
                    f"(waiting for {states})")
            time.sleep(0.01)

    def stats(self) -> dict:
        with self._lock:
            return {"children": {
                ch.name: {"state": ch.state, "restarts": ch.restarts,
                          "last_exit": ch.last_exit,
                          "pid": (None if ch.proc is None
                                  else ch.proc.pid),
                          "alive": (ch.proc is not None
                                    and ch.proc.is_alive())}
                for ch in self._children.values()}}


def write_restart_flag(flag_dir: str, name: str) -> str:
    """Drop the restart flag the supervisor watches for — the signal a
    replica's ``on_writer_dead`` callback sends (atomic create; racing
    writers are harmless, the flag is level-triggered)."""
    path = os.path.join(flag_dir, f"{name}.restart")
    with open(path, "w") as fh:
        fh.write(str(time.time()))
    return path


def write_event(flag_dir: str, name: str, event: str,
                detail: str = "") -> str:
    """Push one event from child ``name`` into the supervisor's log
    (appends a JSON line to ``{name}.events``; the monitor thread
    ingests the file on its next tick).  The cross-process half of the
    integrity plane's reporting: quarantines and scrub violations land
    in the same ordered timeline as the restarts they explain."""
    path = os.path.join(flag_dir, f"{name}.events")
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps({"event": str(event),
                             "detail": str(detail)}) + "\n")
    return path
