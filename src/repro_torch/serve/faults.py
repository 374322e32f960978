"""Deterministic fault injection for the serving plane (DESIGN.md §9).  A
copy of ``repro.serve.faults`` for the port (the standard library only).

The chaos tests and the ``benchmarks/chaos.py`` kill-and-restart cycles
need *reproducible* failures: a fault must fire at the same logical
point of the run every time, independent of thread scheduling or wall
clock.  So every fault here triggers on a **counter the instrumented
site passes in** — a stream version, a snapshot publish version, a
request ordinal — never on elapsed time.  A :class:`FaultPlan` is a
JSON-serialisable list of :class:`Fault` records plus a seed; the seed
feeds :meth:`FaultPlan.scattered`, which derives drop/slow request
ordinals from a splitmix64 stream so a whole chaos run is replayable
from one integer.

Fault sites (the strings instrumented code fires):

* ``write``   — fired by ``TriclusterService._write`` with the miner's
  new ``stream_version``: ``kill`` here is *kill-shard-at-version-N*.
* ``publish`` — fired by ``ShmPublisher.publish`` with the snapshot
  version, before any segment bytes are written.
* ``torn``    — fired by ``ShmPublisher._swing`` **while the seqlock is
  odd**: ``kill`` here dies mid-publish, leaving a stuck-odd control
  block and an orphaned data segment (the crash-safe-shm test fixture).
* ``request`` — fired by the HTTP front-ends per request (ordinal
  counter): ``drop`` severs the connection with no response, ``slow``
  and ``hang`` delay it (``hang`` defaults to effectively forever —
  the circuit-breaker fixture).

**Corruption sites** (the fail-silent half — DESIGN.md §9): three
sites are *polled* via :meth:`FaultInjector.corrupt` instead of fired,
because the corruption itself must be enacted by the code that owns
the bytes, **after** the protecting checksum was computed — so the
integrity plane's detection, not luck, is what the chaos run gates:

* ``wal``        — polled by ``TriclusterService._wal_append`` with
  the record's stream version: ``flip`` rots one byte of the framed
  payload on disk (the in-memory apply is untouched — silent at-rest
  corruption).
* ``checkpoint`` — polled after ``RunStore`` checkpoint persistence
  with the publish version: ``truncate`` cuts the blob in half.
* ``shm``        — polled by ``ShmPublisher.publish`` after the
  arrays are written: ``flip`` inverts one aligned word of the first
  sizeable array in the segment.

Plans are scoped per component: ``plan.for_component(role, shard,
replica)`` returns the :class:`FaultInjector` holding exactly the
faults aimed at that component (``-1`` fields are wildcards), so one
plan string can be handed to every process of a plane
(``launch/cluster_serve.py --fault-plan``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

#: exit status of an injected ``kill`` — distinctive, so supervisors and
#: tests can tell an injected crash from a genuine one.
KILL_EXIT_CODE = 23

KINDS = ("kill", "hang", "drop", "slow", "flip", "truncate")
SITES = ("write", "publish", "torn", "request", "wal", "checkpoint", "shm")
ROLES = ("writer", "replica", "router", "*")

#: kinds enacted by the *call site* via :meth:`FaultInjector.corrupt`
#: rather than by :meth:`FaultInjector.fire`
CORRUPT_KINDS = ("flip", "truncate")


class DropRequest(Exception):
    """Raised by a ``drop`` fault: the HTTP handler must sever the
    connection without writing any response (a torn backend)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One armed fault.  ``at`` is compared against the counter the
    site fires with; ``every`` re-arms periodically past ``at``;
    ``count`` caps total firings (0 = unlimited)."""
    kind: str                 # kill | hang | drop | slow | flip | truncate
    site: str                 # write | publish | torn | request | wal | checkpoint | shm
    role: str = "*"           # writer | replica | router | *
    shard: int = -1           # -1 = any
    replica: int = -1         # -1 = any
    at: int = 0
    every: int = 0
    count: int = 1
    param: float = 0.0        # seconds (hang/slow); unused otherwise

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.role not in ROLES:
            raise ValueError(f"unknown fault role {self.role!r}")

    def matches(self, role: str, shard: int, replica: int) -> bool:
        return ((self.role in ("*", role))
                and (self.shard < 0 or self.shard == int(shard))
                and (self.replica < 0 or self.replica == int(replica)))

    def due(self, value: int, fired: int) -> bool:
        # count=0 means unlimited, but a cleared fault (fired forced
        # huge by FaultInjector.clear) must stay disarmed
        if fired >= (self.count or (1 << 30)):
            return False
        if value < self.at:
            return False
        if self.every > 0:
            return (value - self.at) % self.every == 0
        return fired == 0


def _splitmix64(x: int) -> int:
    """One step of splitmix64 — the deterministic ordinal stream behind
    :meth:`FaultPlan.scattered` (no numpy: replicas stay light)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, serialisable set of faults for one chaos run."""
    faults: Tuple[Fault, ...] = ()
    seed: int = 0

    # -- construction helpers ------------------------------------------------

    @staticmethod
    def build(*faults: Fault, seed: int = 0) -> "FaultPlan":
        return FaultPlan(tuple(faults), int(seed))

    @staticmethod
    def kill_writer(shard: int, at_stream_version: int) -> Fault:
        """Kill shard ``shard``'s writer when its stream version
        reaches N (hard ``os._exit`` — no cleanup runs)."""
        return Fault("kill", "write", role="writer", shard=shard,
                     at=int(at_stream_version))

    @staticmethod
    def kill_writer_at_publish(shard: int, at_version: int) -> Fault:
        """Kill the writer when it is about to publish snapshot
        version N (before any shm bytes are written)."""
        return Fault("kill", "publish", role="writer", shard=shard,
                     at=int(at_version))

    @staticmethod
    def torn_publish(shard: int, at_version: int) -> Fault:
        """Kill the writer mid-seqlock-swing of snapshot version N:
        the control block is left odd, the data segment orphaned."""
        return Fault("kill", "torn", role="writer", shard=shard,
                     at=int(at_version))

    @staticmethod
    def hang_replica(shard: int, replica: int, at_request: int,
                     for_s: float = 3600.0, count: int = 1) -> Fault:
        """Replica ``(shard, replica)`` blocks its ``at_request``-th
        request for ``for_s`` seconds (default: effectively forever)."""
        return Fault("hang", "request", role="replica", shard=shard,
                     replica=replica, at=int(at_request),
                     count=int(count), param=float(for_s))

    @staticmethod
    def flip_wal_byte(shard: int, at_stream_version: int,
                      count: int = 1) -> Fault:
        """Rot one byte of the WAL record framed at stream version N —
        after its CRC was computed, so only replay-time verification
        can catch it (the victim's in-memory state is untouched)."""
        return Fault("flip", "wal", role="writer", shard=shard,
                     at=int(at_stream_version), count=int(count))

    @staticmethod
    def truncate_checkpoint(shard: int, at_version: int,
                            count: int = 1) -> Fault:
        """Cut the checkpoint blob persisted at publish version N in
        half on disk — the framed length/CRC header must reject it and
        recovery must fall back to the previous generation."""
        return Fault("truncate", "checkpoint", role="writer",
                     shard=shard, at=int(at_version), count=int(count))

    @staticmethod
    def flip_shm_word(shard: int, at_version: int,
                      count: int = 1) -> Fault:
        """Invert one aligned 8-byte word inside the data segment of
        snapshot version N, after the manifest checksums were taken —
        replicas must refuse the segment at attach-time verify."""
        return Fault("flip", "shm", role="writer", shard=shard,
                     at=int(at_version), count=int(count))

    @staticmethod
    def drop_requests(role: str, shard: int, at: int, every: int = 0,
                      count: int = 1, replica: int = -1) -> Fault:
        """Sever matching requests without any response bytes."""
        return Fault("drop", "request", role=role, shard=shard,
                     replica=replica, at=int(at), every=int(every),
                     count=int(count))

    @staticmethod
    def slow_requests(role: str, shard: int, at: int, delay_s: float,
                      every: int = 0, count: int = 1,
                      replica: int = -1) -> Fault:
        return Fault("slow", "request", role=role, shard=shard,
                     replica=replica, at=int(at), every=int(every),
                     count=int(count), param=float(delay_s))

    @staticmethod
    def scattered(seed: int, role: str, shard: int, window: int,
                  n_drop: int = 0, n_slow: int = 0,
                  slow_s: float = 0.05, replica: int = -1,
                  offset: int = 1) -> "FaultPlan":
        """Seed-derived dropped/slow responses: ``n_drop + n_slow``
        distinct request ordinals drawn deterministically from
        ``[offset, offset + window)`` via splitmix64 — the replayable
        "flaky backend" of the chaos benchmark."""
        picks: List[int] = []
        x = (int(seed) << 1) | 1
        while len(picks) < n_drop + n_slow:
            x = _splitmix64(x)
            o = offset + (x % max(1, int(window)))
            if o not in picks:
                picks.append(o)
        faults = [FaultPlan.drop_requests(role, shard, at=o,
                                          replica=replica)
                  for o in picks[:n_drop]]
        faults += [FaultPlan.slow_requests(role, shard, at=o,
                                           delay_s=slow_s,
                                           replica=replica)
                   for o in picks[n_drop:]]
        return FaultPlan(tuple(faults), int(seed))

    # -- serialisation -------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "faults": [dataclasses.asdict(f)
                                      for f in self.faults]})

    @staticmethod
    def from_json(s: str) -> "FaultPlan":
        doc = json.loads(s)
        return FaultPlan(tuple(Fault(**f) for f in doc.get("faults", ())),
                         int(doc.get("seed", 0)))

    def merge(self, other: "FaultPlan") -> "FaultPlan":
        return FaultPlan(self.faults + other.faults, self.seed)

    # -- scoping -------------------------------------------------------------

    def for_component(self, role: str, shard: int = 0,
                      replica: int = -1) -> "FaultInjector":
        sel = tuple(f for f in self.faults
                    if f.matches(role, shard, replica))
        return FaultInjector(sel)


class FaultInjector:
    """The per-component runtime: instrumented sites call
    :meth:`fire` with their counter; armed faults act.  Thread-safe;
    cheap when empty (components hold ``None`` instead when no plan is
    threaded through, so the truly-disabled path is one ``is None``)."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults = tuple(faults)
        self._fired = [0] * len(self.faults)
        self._counters: dict = {}
        self._lock = threading.Lock()

    def __bool__(self) -> bool:
        return bool(self.faults)

    def fired(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(n for f, n in zip(self.faults, self._fired)
                       if site is None or f.site == site)

    def clear(self, site: Optional[str] = None) -> None:
        """Disarm matching faults (future fires become no-ops)."""
        with self._lock:
            for i, f in enumerate(self.faults):
                if site is None or f.site == site:
                    self._fired[i] = max(self._fired[i],
                                         f.count if f.count else 1 << 30)

    def fire(self, site: str, value: Optional[int] = None) -> None:
        """Report that ``site`` reached ``value`` (or its next internal
        ordinal).  May sleep (hang/slow), raise :class:`DropRequest`,
        or terminate the process (kill) — in that priority order a
        given call resolves at most one *kill*, after honouring any
        matching delays."""
        if not self.faults:
            return
        actions: List[Fault] = []
        with self._lock:
            if value is None:
                value = self._counters.get(site, 0) + 1
                self._counters[site] = value
            for i, f in enumerate(self.faults):
                if f.site != site or f.kind in CORRUPT_KINDS:
                    continue
                if f.due(int(value), self._fired[i]):
                    self._fired[i] += 1
                    actions.append(f)
        drop = False
        for f in actions:
            if f.kind in ("hang", "slow"):
                time.sleep(f.param if f.param > 0 else 3600.0)
            elif f.kind == "drop":
                drop = True
        for f in actions:
            if f.kind == "kill":
                # a *crash*, not an exit: no atexit, no finally blocks,
                # no publisher cleanup — exactly what recovery must
                # survive
                os._exit(KILL_EXIT_CODE)
        if drop:
            raise DropRequest(f"injected drop at {site}#{value}")

    def corrupt(self, site: str, value: int) -> Optional[Fault]:
        """Poll the corruption sites: return the armed ``flip`` /
        ``truncate`` fault due at ``value`` (marking it fired), else
        ``None``.  Unlike :meth:`fire`, the *caller* enacts the damage
        — it owns the bytes being rotted and must do so after the
        protecting checksum was computed."""
        if not self.faults:
            return None
        with self._lock:
            for i, f in enumerate(self.faults):
                if f.site != site or f.kind not in CORRUPT_KINDS:
                    continue
                if f.due(int(value), self._fired[i]):
                    self._fired[i] += 1
                    return f
        return None


#: shared no-op injector for call sites that want an always-valid object
NO_FAULTS = FaultInjector(())
