"""Zero-copy snapshot bundles over POSIX shared memory (DESIGN.md §8).
Port of ``repro.serve.shm``: the segment format (control block layout,
manifest JSON, 64-byte alignment, ``sum64``) is the JAX package's byte
for byte, so either package attaches the other's segments.  Everything
here is host numpy: a writer publishes the arrays its index build left
on the host, and a replica never touches the card.

One serving process mines and builds indexes; N *replica reader*
processes answer queries.  The bridge between them is this module: the
writer publishes every snapshot's stacked arrays — membership words,
component members/bounds, packed signatures, scores, per-row stats —
into a ``multiprocessing.shared_memory`` segment, and replicas map the
segment and serve straight out of it (``np.frombuffer`` views, no
copy, no deserialisation).

**Memory model.**  Two kinds of segments per ``prefix``:

* ``{prefix}.ctl`` — a fixed 4 KiB *control block*, created once by the
  writer.  It names the current data segment and carries the snapshot
  version, stream version, publish wall-time and cluster count behind a
  *seqlock*: the writer bumps a sequence word to odd, rewrites the
  payload, bumps it to even; a reader re-reads until it observes the
  same even sequence before and after — so a reader never acts on a
  torn control block.  A separate ``dirty`` slot (the write backlog)
  sits outside the seqlock payload and is updated on every write
  without bumping the sequence.
* ``{prefix}.v{version}`` — one immutable *data segment per snapshot*:
  an 8-byte header length, a JSON manifest (array names / dtypes /
  shapes / offsets / **per-array 64-bit checksums** + snapshot meta),
  then the arrays, 64-byte aligned.  Data segments are never mutated after the
  control block names them — single-reference swap semantics, exactly
  like the in-process ``TriclusterService`` snapshot swap.

**Integrity.**  The manifest checksums are the fail-silent defence
(DESIGN.md §9): :class:`SnapshotBundle` verifies every array against
its recorded :func:`checksum64` at attach time and refuses the segment
with :class:`ShmCorruptionError` on mismatch, and :class:`ReplicaService`
re-verifies the held bundle opportunistically (one rotating array per
scrub tick) — a word flipped *after* attach is caught between swaps,
not served.  Either detection escalates exactly like a dead writer:
keep serving the last good snapshot, signal the supervisor
(``on_writer_dead`` path) so the writer republishes under a new epoch.

**Reclamation.**  After publishing version ``v`` the writer *unlinks*
segment ``v-1``.  POSIX keeps the memory alive until the last process
unmaps it, so replicas still serving ``v-1`` are never torn; the
segment is physically reclaimed when the last reader drops its mapping
(replicas drop theirs when they attach ``v``; CPython refcounting frees
the old mapping as soon as no in-flight query holds a view).  A replica
that loses the attach race (control named ``v`` but the writer already
moved on and unlinked it) just re-reads the control block and retries.

Replicas must *not* let Python's ``resource_tracker`` adopt attached
segments — it would unlink live segments when the replica exits — so
:func:`attach_segment` detaches them from tracking (``track=False``
where available, else explicit unregister).
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
from multiprocessing import shared_memory
from typing import List, Optional

import numpy as np

CTL_SIZE = 4096
# seq, epoch, version, stream_version, wall, n, name_len — ``epoch``
# increments each time a (re)started writer adopts the prefix, so a
# restarted writer's first publish is unambiguous to readers even if
# its version numbering restarted (bundle identity is (epoch, version))
_CTL_FMT = "<QQQQdQQ"
_CTL_PAYLOAD = struct.calcsize(_CTL_FMT)
_NAME_OFF = _CTL_PAYLOAD
_NAME_MAX = 200
_DIRTY_OFF = 512         # outside the seqlock payload (see module doc)
_PID_OFF = 520           # writer pid — the reader-side liveness probe
_ALIGN = 64


class ShmCorruptionError(RuntimeError):
    """A mapped data segment failed its manifest checksums (or its
    arrays violate structural invariants): the bytes in shared memory
    are not the bytes the writer published.  Readers must not serve
    from the segment — they keep their held snapshot and escalate along
    the ``on_writer_dead`` path so the supervisor makes the writer
    republish (a restart bumps the epoch; the next clean attach clears
    the condition)."""


class WriterDeadError(RuntimeError):
    """The seqlock stayed odd past the spin bound and (re-attach
    confirmed) the writer cannot finish the swing: it crashed
    mid-publish, or is alive but wedged.  Readers keep serving their
    held snapshot; whoever supervises the writer should restart it."""

    def __init__(self, prefix: str, pid: int, alive: bool):
        state = ("alive but stuck" if alive else "dead")
        super().__init__(f"publisher of {prefix!r} is {state} "
                         f"(pid {pid}): seqlock stuck odd")
        self.prefix, self.pid, self.alive = prefix, pid, alive


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


class _Segment(shared_memory.SharedMemory):
    """SharedMemory whose ``close`` tolerates live zero-copy views:
    ``mmap.close`` refuses while exported buffers exist (in-flight
    queries still reading the old snapshot), and that is fine — the
    mapping is freed when the last view dies."""

    def close(self):                         # also guards __del__
        try:
            super().close()
        except BufferError:
            pass


def _untrack(name: str) -> None:
    """Detach a segment from this process's ``resource_tracker`` (the
    tracker would unlink it when the process dies — wrong for segments
    whose lifetime must span a crash)."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister(name, "shared_memory")
    except Exception:                        # noqa: BLE001 — advisory
        pass


def attach_segment(name: str) -> shared_memory.SharedMemory:
    """Attach an existing segment *without* resource-tracker ownership
    (the writer owns unlink; a tracked reader would destroy live
    segments on exit)."""
    try:
        return _Segment(name=name, track=False)
    except TypeError:                        # Python < 3.13: no track=
        seg = _Segment(name=name)
        _untrack(seg._name)
        return seg


def _unlink_segment(seg: shared_memory.SharedMemory) -> None:
    """Unlink with a balanced resource-tracker state: re-register first
    (a set add — idempotent), so unlink's unregister never targets an
    absent name (which the tracker process logs as a KeyError when a
    same-process reader already unregistered it)."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.register(seg._name, "shared_memory")
    except Exception:                        # noqa: BLE001 — advisory
        pass
    try:
        seg.unlink()
    except FileNotFoundError:
        pass


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


_M64 = (1 << 64) - 1


def checksum64(data) -> int:
    """64-bit content checksum of an array or buffer: one single-pass
    wrap-around ``uint64`` sum over the 8-byte words, tail bytes and
    length folded in, finished with a splitmix64-style mix.

    This is the **shared-memory manifest** checksum, chosen over
    ``zlib.crc32`` deliberately: crc32 streams bytes through zlib at
    ~1 GB/s, which on a small host is a visible fraction of every
    snapshot-swap; the NumPy reduction runs at memory bandwidth
    (>10 GB/s), keeping the clean-path verify cost inside the ≤5%
    overhead budget (DESIGN.md §9).  Detection guarantee: *any*
    corruption confined to a single 64-bit word — every bit-flip burst
    the fault injector or real bit rot produces in one word — always
    changes the sum (by ``w' - w ≠ 0 mod 2^64``); independent
    multi-word damage escapes with probability ~2^-64, better odds
    than crc32's 2^-32.  The mix step keeps single-word deltas from
    producing correlated checksum deltas.  The WAL and checkpoint
    frames keep CRC32: they are off the swap path, and byte-granular
    torn-tail detection matters more there."""
    if isinstance(data, np.ndarray):
        mv = memoryview(np.ascontiguousarray(data)).cast("B")
    else:
        mv = memoryview(data).cast("B")
    n = len(mv)
    k = n - n % 8
    s = 0
    if k:
        s = int(np.add.reduce(np.frombuffer(mv[:k], dtype="<u8"),
                              dtype=np.uint64))
    tail = int.from_bytes(mv[k:], "little") if k < n else 0
    h = ((n ^ s) * 0x9E3779B97F4A7C15) & _M64
    h ^= h >> 30
    h = ((h ^ tail) * 0xBF58476D1CE4E5B9) & _M64
    return (h ^ (h >> 31)) & _M64


class SnapshotBundle:
    """One mapped data segment: zero-copy array views + snapshot meta.
    Holds the segment mapping alive exactly as long as any of its
    arrays (or itself) is referenced.

    Attach is the integrity gate: every array is checksummed against
    the manifest's recorded :func:`checksum64` before the bundle is
    usable (``verify=False`` skips it — benchmark baseline only).
    Legacy manifests without checksums attach unverified."""

    def __init__(self, seg: shared_memory.SharedMemory,
                 verify: bool = True):
        self._seg = seg
        (hlen,) = struct.unpack_from("<Q", seg.buf, 0)
        head = json.loads(bytes(seg.buf[8:8 + hlen]))
        self.meta: dict = head["meta"]
        self.manifest: list = head["arrays"]
        self.version: int = int(self.meta["version"])
        self.epoch: int = int(self.meta.get("epoch", 1))
        self.stream_version: int = int(self.meta["stream_version"])
        self.published_wall: float = float(self.meta["published_wall"])
        self.arrays: dict = {}
        for a in self.manifest:
            arr = np.frombuffer(seg.buf, dtype=np.dtype(a["dtype"]),
                                count=int(np.prod(a["shape"], dtype=int)),
                                offset=a["offset"]).reshape(a["shape"])
            arr.flags.writeable = False
            self.arrays[a["name"]] = arr
        if verify:
            bad = self.verify()
            if bad:
                raise ShmCorruptionError(
                    f"segment {getattr(seg, 'name', '?')} v"
                    f"{self.version}: checksum mismatch in "
                    f"{', '.join(bad)}")

    def verify(self, names: Optional[List[str]] = None) -> List[str]:
        """Re-checksum mapped arrays against the manifest (all of them,
        or just ``names``) and return the mismatching array names.
        Runs over the raw segment bytes — no copies.  Entries without a
        recorded checksum (legacy manifests) pass vacuously."""
        bad: List[str] = []
        for a in self.manifest:
            if names is not None and a["name"] not in names:
                continue
            want = a.get("sum64")
            if want is None:
                continue
            o = int(a["offset"])
            nbytes = int(self.arrays[a["name"]].nbytes)
            if checksum64(self._seg.buf[o:o + nbytes]) != int(want):
                bad.append(a["name"])
        return bad


class ShmPublisher:
    """Writer side: owns the control block, publishes one data segment
    per snapshot, unlinks the previous one after each swap.

    Crash safety: adopting a dead predecessor's control block bumps the
    **epoch** (readers see an unambiguous new writer), records the last
    version the predecessor named (``resumed_version`` — the restart's
    version floor), garbage-collects every orphaned ``{prefix}.v*``
    data segment the crash leaked, and stamps this process's pid into
    the control block for the readers' stuck-odd liveness probe."""

    def __init__(self, prefix: str, fault=None, checksums: bool = True):
        if len(prefix) + 16 > _NAME_MAX:
            raise ValueError(f"prefix too long: {prefix!r}")
        self.prefix = prefix
        self.fault = fault
        #: record per-array :func:`checksum64` values in the manifest
        #: (the attach-time integrity gate); False is the
        #: overhead-benchmark baseline
        self.checksums = bool(checksums)
        self._seq = 0
        self.epoch = 1
        self.resumed_version = 0
        self._data: Optional[shared_memory.SharedMemory] = None
        try:
            self._ctl = _Segment(
                name=f"{prefix}.ctl", create=True, size=CTL_SIZE)
            # the control block is the crash-durable rendezvous — it
            # carries the epoch watermark a restarted writer must read,
            # so the resource tracker must not unlink it on crash
            _untrack(self._ctl._name)
        except FileExistsError:
            # a stale control block from a dead writer: adopt, recover
            # its (epoch, version) watermark — possibly written by a
            # crash mid-swing, hence read raw, no seqlock — and reset
            self._ctl = attach_segment(f"{prefix}.ctl")
            _, epoch, ver, *_ = struct.unpack_from(_CTL_FMT,
                                                   self._ctl.buf, 0)
            self.epoch = int(epoch) + 1
            self.resumed_version = int(ver)
        self._ctl.buf[:CTL_SIZE] = b"\0" * CTL_SIZE
        struct.pack_into("<Q", self._ctl.buf, _PID_OFF, os.getpid())
        self.reclaimed = self._gc_orphans()

    def _gc_orphans(self) -> int:
        """Unlink every leftover ``{prefix}.v*`` data segment of a dead
        predecessor (readers still mapping one keep it alive — unlink
        only removes the name).  Without this, a restart that republishes
        a version number its predecessor already used would collide with
        the orphan and crash-loop."""
        n = 0
        shm_dir = "/dev/shm"                 # POSIX shm namespace; the
        if not os.path.isdir(shm_dir):       # only portable way to list
            return 0
        for entry in os.listdir(shm_dir):
            if not entry.startswith(f"{self.prefix}.v"):
                continue
            try:
                seg = attach_segment(entry)
                seg.close()
                _unlink_segment(seg)
                n += 1
            except FileNotFoundError:
                pass
        return n

    def publish(self, version: int, stream_version: int,
                arrays: dict, meta: Optional[dict] = None,
                published_wall: Optional[float] = None) -> str:
        """Write ``arrays`` into a fresh ``{prefix}.v{version}`` segment
        and swing the control block to it; then unlink the previous
        segment (readers still mapping it keep it alive)."""
        if self.fault is not None:
            self.fault.fire("publish", int(version))
        wall = time.time() if published_wall is None else published_wall
        manifest, offset = [], 0
        for k, v in arrays.items():
            if not isinstance(v, np.ndarray):
                # a tensor here would be a device read hidden in publish
                raise TypeError(f"published array {k!r} is a "
                                f"{type(v).__name__}, not a host numpy "
                                "array")
        items = [(k, np.ascontiguousarray(v)) for k, v in arrays.items()]
        # header size depends on offsets which depend on header size:
        # reserve generously once, then lay arrays after it
        probe = json.dumps({"meta": dict(meta or {}), "arrays": [
            {"name": k, "dtype": str(v.dtype), "shape": list(v.shape),
             "offset": 0, "sum64": _M64}
            for k, v in items]}).encode()
        data_off = _pad(8 + len(probe) + 4096)
        offset = data_off
        for k, v in items:
            ent = {"name": k, "dtype": str(v.dtype),
                   "shape": list(v.shape), "offset": offset}
            if self.checksums:
                # checksum the source array, not the segment copy: the
                # manifest records what the writer *meant* to publish,
                # so any later mutation of the shared bytes — torn
                # write, stray DMA, injected flip — fails attach verify
                ent["sum64"] = checksum64(v)
            manifest.append(ent)
            offset = _pad(offset + v.nbytes)
        m = dict(meta or {})
        m.update(version=int(version), stream_version=int(stream_version),
                 published_wall=wall, epoch=int(self.epoch))
        head = json.dumps({"meta": m, "arrays": manifest}).encode()
        if 8 + len(head) > data_off:
            raise ValueError("header overflow")          # 4 KiB slack
        name = f"{self.prefix}.v{int(version)}"
        seg = _Segment(name=name, create=True,
                       size=max(offset, data_off + 1))
        struct.pack_into("<Q", seg.buf, 0, len(head))
        seg.buf[8:8 + len(head)] = head
        for spec, (_, v) in zip(manifest, items):
            o = spec["offset"]
            seg.buf[o:o + v.nbytes] = v.tobytes()
        if self.fault is not None \
                and self.fault.corrupt("shm", int(version)) is not None:
            # injected bit rot: invert one aligned word of the first
            # sizeable array *after* its checksum was recorded — the
            # replicas' attach-time verify, not reader luck, is what
            # stands between this segment and wrong answers
            self._flip_word(seg, manifest)
        self._swing(version, stream_version, wall,
                    int(arrays.get("packed_sigs", np.zeros(0)).shape[0]),
                    name)
        prev, self._data = self._data, seg
        if prev is not None:
            prev.close()
            _unlink_segment(prev)
        return name

    def publish_snapshot(self, snap, sizes=None) -> str:
        """Publish a ``serve.service.Snapshot`` whose index carries the
        stacked arrays (``supports_delta``)."""
        idx = snap.index
        if not idx.supports_delta:
            raise ValueError("index lacks stacked arrays — build it "
                             "with from_result/delta_from_result")
        arrays = {
            "packed_sigs": idx.packed_sigs,
            "any_pairs": idx.any_pairs,
            "scores": snap.querier.scores,
            "ages": np.asarray(snap.ages, np.float64),
            # straight off the index's stats arrays — publishing must
            # not force the lazy view list
            "density": np.asarray(idx.density, np.float64),
            "gen_count": np.asarray(idx.gen_count, np.int64),
            "volume": np.asarray(idx.volume, np.float64),
        }
        for k in range(len(idx.mode_pairs)):
            arrays[f"mode_pairs_{k}"] = idx.mode_pairs[k]
            arrays[f"comp_ents_{k}"] = idx.comp_ents[k]
            arrays[f"comp_bounds_{k}"] = idx.comp_bounds[k]
        meta = {"n_modes": len(idx.mode_pairs),
                "sizes": [] if sizes is None else [int(s) for s in sizes]}
        return self.publish(snap.version, snap.stream_version, arrays,
                            meta=meta,
                            published_wall=getattr(snap, "published_wall",
                                                   None))

    @staticmethod
    def _flip_word(seg, manifest) -> None:
        for spec in manifest:
            n = (int(np.prod(spec["shape"], dtype=int))
                 * np.dtype(spec["dtype"]).itemsize)
            if n >= 8:
                o = int(spec["offset"]) + (n // 16) * 8
                w = bytes(seg.buf[o:o + 8])
                seg.buf[o:o + 8] = bytes(b ^ 0xFF for b in w)
                return

    def _swing(self, version, stream_version, wall, n, name) -> None:
        nb = name.encode()
        self._seq += 1                                   # odd: writing
        struct.pack_into("<Q", self._ctl.buf, 0, self._seq)
        struct.pack_into(_CTL_FMT, self._ctl.buf, 0, self._seq,
                         int(self.epoch), int(version),
                         int(stream_version), float(wall),
                         int(n), len(nb))
        self._ctl.buf[_NAME_OFF:_NAME_OFF + len(nb)] = nb
        if self.fault is not None:
            # the torn-publish site: a "kill" armed here dies with the
            # seqlock odd and the new segment orphaned
            self.fault.fire("torn", int(version))
        self._seq += 1                                   # even: stable
        struct.pack_into("<Q", self._ctl.buf, 0, self._seq)

    def update_dirty(self, dirty: int) -> None:
        """Advisory write-backlog slot; no seqlock bump (see module
        doc), so replicas surface it without re-attaching anything."""
        struct.pack_into("<Q", self._ctl.buf, _DIRTY_OFF, int(dirty))

    def close(self, unlink: bool = True) -> None:
        if self._data is not None:
            self._data.close()
            if unlink:
                _unlink_segment(self._data)
            self._data = None
        self._ctl.close()
        if unlink:
            _unlink_segment(self._ctl)


class ShmReplica:
    """Reader side: seqlock-consistent control reads + data-segment
    attach with swap-race retry.  Thread-safe; meant to back one
    replica process's query surface (``ReplicaService``)."""

    def __init__(self, prefix: str, connect_timeout: float = 60.0,
                 seqlock_spin_s: float = 1.0):
        self.prefix = prefix
        #: bounded-spin budget for an odd seqlock before the stuck-odd
        #: protocol (re-attach, probe the writer pid, declare it dead)
        self.seqlock_spin_s = float(seqlock_spin_s)
        self._lock = threading.Lock()
        self._bundle: Optional[SnapshotBundle] = None
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                self._ctl = attach_segment(f"{prefix}.ctl")
                break
            except FileNotFoundError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"no publisher control block {prefix!r}.ctl "
                        f"after {connect_timeout}s") from None
                time.sleep(0.05)

    def _reattach_ctl(self) -> None:
        """Drop and re-open the control mapping — a restarted writer
        may have replaced the segment behind the old name."""
        old = self._ctl
        self._ctl = attach_segment(f"{self.prefix}.ctl")
        old.close()

    def read_control(self) -> dict:
        """One seqlock-consistent control read (never torn).

        A writer normally holds the lock odd for microseconds; odd past
        ``seqlock_spin_s`` means the writer died (or wedged) mid-swing.
        The stuck-odd protocol then runs: re-attach the control block
        (it may have been recreated), give it one more spin budget, and
        if still odd raise :class:`WriterDeadError` carrying the
        writer-pid liveness probe — the caller keeps serving its held
        snapshot and signals the supervisor."""
        reattached = False
        deadline = time.monotonic() + self.seqlock_spin_s
        while True:
            buf = self._ctl.buf
            (s1,) = struct.unpack_from("<Q", buf, 0)
            if s1 % 2:                       # writer mid-swing
                if time.monotonic() >= deadline:
                    if not reattached:
                        reattached = True
                        self._reattach_ctl()
                        deadline = (time.monotonic()
                                    + self.seqlock_spin_s)
                        continue
                    (pid,) = struct.unpack_from("<Q", buf, _PID_OFF)
                    raise WriterDeadError(self.prefix, int(pid),
                                          _pid_alive(int(pid)))
                time.sleep(0.0002)
                continue
            seq, epoch, ver, sv, wall, n, nlen = struct.unpack_from(
                _CTL_FMT, buf, 0)
            name = bytes(buf[_NAME_OFF:_NAME_OFF + nlen]).decode()
            (dirty,) = struct.unpack_from("<Q", buf, _DIRTY_OFF)
            (pid,) = struct.unpack_from("<Q", buf, _PID_OFF)
            (s2,) = struct.unpack_from("<Q", buf, 0)
            if s1 == s2:
                return {"version": ver, "epoch": epoch,
                        "stream_version": sv,
                        "published_wall": wall, "clusters": n,
                        "segment": name, "dirty": dirty,
                        "writer_pid": pid}

    def current(self) -> Optional[SnapshotBundle]:
        """The bundle for the control block's current snapshot,
        (re-)attaching on (epoch, version) change; None until the
        writer has published anything.  Losing the attach race to a
        concurrent swap (segment already unlinked) retries off the
        fresh control block."""
        while True:
            ctl = self.read_control()
            if ctl["version"] == 0:
                return None
            ident = (ctl["epoch"], ctl["version"])
            b = self._bundle
            if b is not None and (b.epoch, b.version) == ident:
                return b
            with self._lock:
                b = self._bundle
                if b is not None and (b.epoch, b.version) == ident:
                    return b
                try:
                    seg = attach_segment(ctl["segment"])
                except FileNotFoundError:
                    continue                 # swapped under us: retry
                bundle = SnapshotBundle(seg)
                # dropping the previous bundle releases our mapping of
                # the old (already unlinked) segment once the last
                # in-flight query referencing its arrays completes
                self._bundle = bundle
                return bundle

    def wait_version(self, at_least: int,
                     timeout: Optional[float] = None) -> SnapshotBundle:
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            b = self.current()
            if b is not None and b.version >= at_least:
                return b
            if deadline is not None and time.monotonic() >= deadline:
                cur = 0 if b is None else b.version
                raise TimeoutError(
                    f"version {at_least} not published within {timeout}s "
                    f"(current: {cur})")
            time.sleep(0.002)

    def close(self) -> None:
        self._bundle = None
        self._ctl.close()


class ReplicaService:
    """Read-only query surface of one replica reader process.

    Maps the writer's shared-memory snapshots (:class:`ShmReplica`),
    reassembles the ``ClusterIndex`` + querier from the zero-copy array
    views on every version change, and answers ``query`` /
    ``query_batch`` / ``snapshot`` with exactly the in-process
    service's semantics (same shared ``snapshot_query`` logic, same
    freshness modes) — so ``serve.protocol.make_server`` serves a
    replica unchanged, minus the write routes (``read_only``)."""

    read_only = True

    def __init__(self, prefix: str, poll_interval: float = 0.005,
                 connect_timeout: float = 60.0,
                 seqlock_spin_s: float = 1.0, on_writer_dead=None,
                 dead_signal_cooldown: float = 5.0,
                 scrub_interval: float = 0.5):
        self.replica = ShmReplica(prefix, connect_timeout=connect_timeout,
                                  seqlock_spin_s=seqlock_spin_s)
        self.poll_interval = float(poll_interval)
        #: called (with the WriterDeadError / ShmCorruptionError) when
        #: the stuck-odd protocol declares the publisher dead or a
        #: segment fails verification — the supervisor signal
        #: (``launch/cluster_serve.py`` wires a restart-flag file here);
        #: rate-limited by ``dead_signal_cooldown``
        self.on_writer_dead = on_writer_dead
        self.dead_signal_cooldown = float(dead_signal_cooldown)
        self._last_dead_signal = -float("inf")
        #: opportunistic re-verify cadence (s): each tick checksums one
        #: rotating array of the *held* bundle, so corruption landing
        #: after a clean attach is caught between swaps; 0 disables
        self.scrub_interval = float(scrub_interval)
        self._last_scrub = 0.0
        self._scrub_cursor = 0
        self._corrupt = False
        self._ident = (0, 0)                  # (epoch, version) served
        self._cv = threading.Condition()
        self._snap = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._stats = {"attaches": 0, "attach_errors": 0,
                       "last_attach_ms": 0.0, "writer_dead_signals": 0,
                       "shm_corruptions": 0, "scrubs": 0,
                       "scrub_violations": []}

    # -- snapshot maintenance ------------------------------------------------

    def _build(self, bundle: SnapshotBundle):
        from . import ranking as R
        from .clusters import ClusterIndex
        from .service import Snapshot
        t0 = time.perf_counter()
        n_modes = int(bundle.meta.get("n_modes", 0))
        a = bundle.arrays
        # structural invariants on top of the checksum gate: they prove
        # the bytes are what the writer published, these prove what it
        # published is servable (a writer-side build gone wrong must
        # not propagate to readers as garbage answers)
        bad: list = []
        ps = a["packed_sigs"]
        if ps.size > 1 and not bool(np.all(ps[:-1] <= ps[1:])):
            bad.append("packed_sigs not sorted")
        if not bool(np.all(np.isfinite(a["scores"]))):
            bad.append("non-finite scores")
        for k in range(n_modes):
            cb = a[f"comp_bounds_{k}"]
            if cb.size > 1 and not bool(np.all(cb[:-1] <= cb[1:])):
                bad.append(f"comp_bounds_{k} not monotone")
        if bad:
            raise ShmCorruptionError(
                f"bundle v{bundle.version}: invariant violations: "
                f"{'; '.join(bad)}")
        idx = ClusterIndex.from_arrays(
            a["packed_sigs"],
            [a[f"mode_pairs_{k}"] for k in range(n_modes)],
            [a[f"comp_ents_{k}"] for k in range(n_modes)],
            [a[f"comp_bounds_{k}"] for k in range(n_modes)],
            a["any_pairs"], a["density"], a["gen_count"], a["volume"])
        querier = R.BatchQuerier(idx, scores=a["scores"])
        snap = Snapshot(version=bundle.version,
                        stream_version=bundle.stream_version,
                        result=None, index=idx, querier=querier,
                        ages=a["ages"], published_at=time.monotonic(),
                        published_wall=bundle.published_wall)
        self._stats["attaches"] += 1
        self._stats["last_attach_ms"] = (time.perf_counter() - t0) * 1e3
        return snap

    def _signal_supervisor(self, err) -> None:
        """Rate-limited escalation callback — one path for a dead
        writer and a corrupt segment (both mean: the writer must
        republish; we keep serving the held snapshot meanwhile)."""
        cb = self.on_writer_dead
        now = time.monotonic()
        if (cb is not None and now - self._last_dead_signal
                >= self.dead_signal_cooldown):
            self._last_dead_signal = now
            try:
                cb(err)
            except Exception:                # noqa: BLE001 — advisory
                pass

    def _writer_dead(self, err: WriterDeadError) -> None:
        self._stats["writer_dead_signals"] += 1
        self._stats["last_writer_dead"] = repr(err)
        self._signal_supervisor(err)

    def _corruption(self, err: ShmCorruptionError) -> None:
        self._stats["shm_corruptions"] += 1
        self._stats["last_shm_corruption"] = repr(err)
        self._signal_supervisor(err)

    def _maybe_attach(self) -> None:
        try:
            ctl = self.replica.read_control()
        except WriterDeadError as e:
            # keep serving the held snapshot; surface the death to the
            # supervisor and move on — recovery is the writer's problem
            self._writer_dead(e)
            return
        ident = (ctl["epoch"], ctl["version"])
        if ctl["version"] == 0 or ident == self._ident:
            return
        try:
            bundle = self.replica.current()
        except ShmCorruptionError as e:
            # refused segment: serve the held snapshot, escalate — the
            # exact opposite of silently serving the corrupt bytes
            self._corruption(e)
            return
        if bundle is None:
            return
        ident = (bundle.epoch, bundle.version)
        if ident == self._ident:
            return
        try:
            snap = self._build(bundle)
        except ShmCorruptionError as e:
            self._corruption(e)
            return
        self._ident = ident
        # a verified attach supersedes any corruption the scrubber
        # found in the previous bundle
        self._corrupt = False
        self._stats["scrub_violations"] = []
        with self._cv:
            self._snap = snap                # the replica's atomic swap
            self._cv.notify_all()

    def _maybe_scrub(self) -> None:
        """Opportunistic held-bundle re-verify: one rotating array's
        checksum per tick, so a full pass completes every
        ``n_arrays * scrub_interval`` seconds without ever stalling
        the attach loop."""
        if self.scrub_interval <= 0:
            return
        now = time.monotonic()
        if now - self._last_scrub < self.scrub_interval:
            return
        self._last_scrub = now
        b = self.replica._bundle
        if b is None or not b.manifest:
            return
        names = sorted(b.arrays)
        name = names[self._scrub_cursor % len(names)]
        self._scrub_cursor += 1
        bad = b.verify([name])
        self._stats["scrubs"] += 1
        if bad:
            self._corrupt = True
            self._stats["scrub_violations"] = [
                f"shm checksum mismatch in held bundle "
                f"v{b.version}: {bad[0]}"]
            self._corruption(ShmCorruptionError(
                f"scrub: array {bad[0]!r} of held segment v"
                f"{b.version} no longer matches its published checksum"))

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self._maybe_attach()
                self._maybe_scrub()
            except Exception as e:           # noqa: BLE001 — keep
                # serving the previous snapshot on any attach failure
                self._stats["attach_errors"] += 1
                self._stats["last_attach_error"] = repr(e)
            self._stop_evt.wait(self.poll_interval)

    def start(self, first_snapshot_timeout: float = 60.0
              ) -> "ReplicaService":
        if self._thread is not None:
            return self
        deadline = time.monotonic() + first_snapshot_timeout
        while self._snap is None:
            self._maybe_attach()
            if self._snap is not None:
                break
            if time.monotonic() >= deadline:
                raise TimeoutError("writer published no snapshot within "
                                   f"{first_snapshot_timeout}s")
            time.sleep(0.02)
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="replica-attach", daemon=True)
        self._thread.start()
        self._started = True
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self.replica.close()

    def __enter__(self) -> "ReplicaService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- service-compatible reader surface -----------------------------------

    @property
    def version(self) -> int:
        snap = self._snap
        return 0 if snap is None else snap.version

    @property
    def stream_version(self) -> int:
        snap = self._snap
        return 0 if snap is None else snap.stream_version

    @property
    def epoch(self) -> int:
        """Writer epoch of the served snapshot (bumps on writer
        restart)."""
        return int(self._ident[0])

    @property
    def thread_alive(self) -> bool:
        """False only when the attach thread was started and died — the
        /health 503 condition (a replica that cannot follow the writer
        any more must be ejected by the balancer)."""
        if not self._started or self._stop_evt.is_set():
            return True
        t = self._thread
        return t is not None and t.is_alive()

    @property
    def dirty(self) -> int:
        """The writer's advisory write-backlog slot."""
        try:
            return int(self.replica.read_control()["dirty"])
        except Exception:                    # noqa: BLE001
            return 0

    @property
    def sizes(self):
        return tuple(int(s) for s in self._meta_sizes())

    def _meta_sizes(self):
        b = self.replica._bundle
        return [] if b is None else b.meta.get("sizes", [])

    def staleness_s(self) -> float:
        """Cross-process staleness: wall-clock now − the writer's
        publish wall time."""
        snap = self._snap
        if snap is None:
            return float("inf")
        return max(0.0, time.time() - snap.published_wall)

    @property
    def scrub_clean(self) -> bool:
        """False while the held bundle is known corrupt (scrub found a
        checksum mismatch and no verified attach has superseded it) — the
        /health 503 condition for silent corruption."""
        return not (self._corrupt or self._stats["scrub_violations"])

    def resilience_stats(self) -> dict:
        """Integrity/escalation counters (mirrors the writer-side and
        router ``resilience_stats`` contract)."""
        s = self._stats
        return {k: s[k] for k in (
            "scrubs", "scrub_violations", "shm_corruptions",
            "writer_dead_signals", "attach_errors")}

    def stats(self) -> dict:
        out = dict(self._stats)
        snap = self._snap
        out.update(role="replica", version=self.version,
                   stream_version=self.stream_version, epoch=self.epoch,
                   clusters=0 if snap is None else len(snap.index),
                   dirty=self.dirty, staleness_s=self.staleness_s(),
                   thread_alive=self.thread_alive,
                   scrub_clean=self.scrub_clean,
                   sizes=list(self._meta_sizes()))
        return out

    def snapshot(self, at_least_version: Optional[int] = None,
                 timeout: Optional[float] = None):
        snap = self._snap
        if at_least_version is None:
            if snap is None:
                raise RuntimeError("no snapshot attached yet")
            return snap
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._snap is None or \
                    self._snap.version < at_least_version:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"version {at_least_version} not published "
                        f"within {timeout}s (current: {self.version})")
                self._cv.wait(timeout=remaining)
            return self._snap

    def query(self, entity=None, mode=None, signature=None, k: int = 10,
              at_least_version: Optional[int] = None,
              timeout: Optional[float] = None):
        from .service import QueryResult, snapshot_query
        snap = self.snapshot(at_least_version, timeout)
        hits = snapshot_query(snap, entity=entity, mode=mode,
                              signature=signature, k=k)
        return QueryResult(snap.version, snap.stream_version, hits)

    def query_batch(self, entities, mode=None, k: int = 10,
                    at_least_version: Optional[int] = None,
                    timeout: Optional[float] = None):
        from .service import QueryResult, snapshot_query_batch
        snap = self.snapshot(at_least_version, timeout)
        return QueryResult(snap.version, snap.stream_version,
                           snapshot_query_batch(snap, entities, mode, k))
