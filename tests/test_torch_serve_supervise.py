"""The port's process supervision (``repro_torch.serve.supervise``) and the
service's integrity events reaching it.  Twins of
``tests/test_serve_faults.py``'s ``TestSupervisor`` and
``TestSupervisorEvents`` against the port, plus parity with the JAX
package: the same transitions give the same bounded event log, the flag
and event files are byte for byte JAX's, and a recovery that quarantines
a rotted WAL record pushes the same events from both services into the
supervisor's log (``TriclusterService(event_dir=...)``)."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from repro.serve import supervise as JS
from repro.serve.service import TriclusterService as JService
from repro_torch.serve import supervise as TS
from repro_torch.serve.service import TriclusterService
from repro_torch.serve.supervise import Supervisor, write_restart_flag

SIZES = (24, 12, 8)


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{what} not reached in {timeout}s")
        time.sleep(0.01)


class _Popen:
    """multiprocessing-Process-shaped adapter over subprocess.Popen."""

    def __init__(self, argv):
        self._p = subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                                   stderr=subprocess.DEVNULL)

    @property
    def pid(self):
        return self._p.pid

    @property
    def exitcode(self):
        return self._p.returncode

    def is_alive(self):
        return self._p.poll() is None

    def terminate(self):
        self._p.terminate()

    def join(self, timeout=None):
        try:
            self._p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass


def _sleeper():
    return _Popen([sys.executable, "-c", "import time; time.sleep(600)"])


def _crasher():
    return _Popen([sys.executable, "-c", "import sys; sys.exit(23)"])


# -- twins of TestSupervisor ------------------------------------------------

def test_restart_then_crash_loop_failure():
    sup = Supervisor(restart_backoff=0.02, backoff_max=0.1, max_restarts=3,
                     restart_window=60.0, poll_interval=0.02)
    sup.add("loop", _crasher)
    sup.add("ok", _sleeper)
    with sup:
        assert sup.wait_state("loop", ("failed",), timeout=30) == "failed"
        st = sup.stats()["children"]
        assert st["loop"]["restarts"] >= 3
        assert st["loop"]["last_exit"] == 23
        assert st["ok"]["state"] == "running" and st["ok"]["alive"]
    events = [e for n, e, _ in sup.events if n == "loop"]
    assert events.count("restarting") >= 3
    assert events[-1] == "failed"


def test_clean_exit_is_not_restarted():
    sup = Supervisor(poll_interval=0.02)
    sup.add("oneshot", lambda: _Popen([sys.executable, "-c", "pass"]))
    with sup:
        assert sup.wait_state("oneshot", ("stopped",),
                              timeout=30) == "stopped"
    assert sup.stats()["children"]["oneshot"]["restarts"] == 0


def test_restart_flag_recycles_hung_child(tmp_path):
    flag_dir = str(tmp_path)
    sup = Supervisor(restart_backoff=0.02, poll_interval=0.02,
                     flag_dir=flag_dir)
    sup.add("writer", _sleeper)
    with sup:
        pid0 = sup.stats()["children"]["writer"]["pid"]
        write_restart_flag(flag_dir, "writer")
        _wait_for(lambda: sup.stats()["children"]["writer"]["restarts"]
                  == 1, what="flagged restart")
        sup.wait_state("writer", ("running",), timeout=30)
        st = sup.stats()["children"]["writer"]
        assert st["alive"] and st["pid"] != pid0
        assert not os.path.exists(os.path.join(flag_dir, "writer.restart"))
    assert ("writer", "flagged", "restart flag") in sup.events


# -- twins of TestSupervisorEvents ------------------------------------------

def test_event_log_rotates_bounded():
    sup = Supervisor(max_events=8)
    for i in range(30):
        sup._event("x", "e", str(i))
    assert len(sup.events) <= 8
    assert sup.events[0][:2] == ("<supervisor>", "rotated")
    assert sup.events_dropped >= 20
    assert sup.events[-1] == ("x", "e", "29")


def test_child_events_ingested_from_flag_dir(tmp_path):
    flag_dir = str(tmp_path)
    TS.write_event(flag_dir, "shard-0", "wal_quarantined",
                   "interior record corrupt at line 3")
    sup = Supervisor(poll_interval=0.02, flag_dir=flag_dir)
    sup.add("shard-0", _sleeper)
    with sup:
        _wait_for(lambda: any(e[1] == "wal_quarantined"
                              for e in sup.events),
                  what="child event ingested")
    name, _, detail = [e for e in sup.events
                       if e[1] == "wal_quarantined"][0]
    assert name == "shard-0" and "line 3" in detail
    assert not os.path.exists(os.path.join(flag_dir, "shard-0.events"))
    assert not os.path.exists(os.path.join(flag_dir,
                                           "shard-0.events.ingest"))


# -- parity with the JAX package --------------------------------------------

@pytest.mark.parametrize("max_events", [8, 9, 64])
def test_event_log_equals_jax(max_events):
    logs = []
    for mod in (JS, TS):
        sup = mod.Supervisor(max_events=max_events)
        for i in range(100):
            sup._event(f"c{i % 3}", ("started", "backoff", "failed")[i % 3],
                       str(i))
        logs.append((sup.events, sup.events_dropped))
    assert logs[1] == logs[0]


def test_flag_and_event_files_equal_jax(tmp_path):
    files = []
    for mod, sub in ((JS, "jax"), (TS, "torch")):
        d = tmp_path / sub
        d.mkdir()
        ev = mod.write_event(str(d), "shard-1", "scrub_violation",
                             'non-finite "scores" — v3')
        mod.write_event(str(d), "shard-1", "wal_quarantined", "line 2")
        flag = mod.write_restart_flag(str(d), "shard-1")
        files.append((os.path.basename(ev), open(ev, "rb").read(),
                      os.path.basename(flag)))
    assert files[1] == files[0]


def _flip_line(path, line, back=3):
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    ln = lines[line]
    pos = len(ln) - back                     # inside the json payload
    lines[line] = ln[:pos] + bytes([ln[pos] ^ 0x01]) + ln[pos + 1:]
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))


def test_integrity_events_reach_the_supervisor(tmp_path):
    """A successor that quarantines a rotted WAL record on recovery
    mirrors the event to ``{event_dir}/{event_name}.events``, as the JAX
    service does, and the port's supervisor adopts it into its log."""
    rng = np.random.default_rng(31)
    chunks = rng.integers(0, SIZES, size=(5, 4, 3)).astype(np.int64)
    pushed = []
    for cls, sub, kw in ((JService, "jax", {}),
                         (TriclusterService, "torch", {"device": "cpu"})):
        rec, flags = tmp_path / sub / "rec", tmp_path / sub / "flags"
        rec.mkdir(parents=True)
        flags.mkdir()
        vic = cls(SIZES, seed=31, recover_dir=str(rec),
                  checkpoint_every=10**6, **kw)
        for c in chunks:
            vic.add(c)
        del vic                              # crash
        _flip_line(str(rec / "wal.jsonl"), 1)
        succ = cls(SIZES, seed=7, recover_dir=str(rec),
                   checkpoint_every=10**6, event_dir=str(flags),
                   event_name="shard-0", **kw)
        assert succ.recovered["replayed_ops"] == 1
        lines = (flags / "shard-0.events").read_text().splitlines()
        pushed.append([ln.split('"detail"')[0] for ln in lines])
        succ.stop()
    assert pushed[1] == pushed[0] and pushed[1]
    assert any('"wal_quarantined"' in ln for ln in pushed[1])
    sup = Supervisor(poll_interval=0.02,
                     flag_dir=str(tmp_path / "torch" / "flags"))
    sup.add("shard-0", _sleeper)
    with sup:
        _wait_for(lambda: any(n == "shard-0" and e == "wal_quarantined"
                              for n, e, _ in sup.events),
                  what="integrity event in the supervisor's log")
