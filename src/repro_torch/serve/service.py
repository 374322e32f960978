"""Online cluster-serving service: snapshot-swapped queries over live
streams (DESIGN.md §8).  Port of ``repro.serve.service``.

The paper stops at the mined result set; this module keeps serving it
while the stream keeps mutating.  A :class:`TriclusterService` owns one
streaming-capable miner (``core.streaming.StreamingMiner`` by default,
or an incremental ``core.distributed.DistributedMiner`` whose
``serving_snapshot`` returns the windowed full-table result) and splits
the world into two paths that never contend:

* **writer path** — ``add`` / ``upsert`` / ``delete`` apply to the
  miner's run store under the writer lock and mark the service dirty.
  Writes are cheap (host-side chunk sort into a new run); they block on
  an in-flight re-mine, never on readers.
* **reader path** — queries read one reference, the *current snapshot*:
  an immutable ``(PipelineResult, ClusterIndex, BatchQuerier, version)``
  bundle.  Publication is a single reference swap, so a reader either
  sees the whole previous snapshot or the whole next one — never a torn
  index — and never takes a lock, so queries never block on mining.

A background thread re-mines on a configurable cadence/dirty-threshold:
when ``dirty >= dirty_threshold`` writes have accumulated, or a write is
older than ``refresh_interval`` seconds, it snapshots the miner (the
incremental merged-run path — only changed chunks were ever sorted),
builds the index + ranking arrays *outside* the reader path, and swaps.

**Versions and freshness.**  Every published snapshot carries
``version`` (publish counter, strictly increasing) and
``stream_version`` (the miner's write counter it covers — the snapshot
versioning hooks in ``core.streaming`` / ``core.distributed``).  Reads
take a freshness mode: ``latest`` (default — whatever is published now,
non-blocking) or ``at_least_version=v`` (block up to ``timeout`` until
``version >= v``; the read-your-writes primitive: upsert, ``refresh()``,
then demand the returned version).

**Recency.**  The service remembers the version that first published
each cluster signature; per-cluster ages feed the ranking layer's
recency term, so freshly emerged clusters can be boosted without any
per-cluster timestamps in the mining pipeline.

**On the card.**  The miner runs on its device (CUDA by default).  A
re-mine reads the leaves the index needs back to the host once
(``serve.clusters.host_result``) while it still holds the writer lock:
that copy is the synchronisation point, so writers wait while the store
is merged and mined, as in the JAX package, and everything after it is
host numpy.  The re-mine thread makes the miner's own device current
before it queues work, and ``stop()`` synchronises that device, so no
work a re-mine queued outlives the service.  Only the miner touches the
card: a shared-memory replica (``serve.shm.ReplicaService``) builds its
``Snapshot`` from host arrays and never creates a CUDA context.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zlib
from typing import Any, List, Optional, Sequence, Tuple

import contextlib

import numpy as np
import torch

from ..core import runs as RS
from ..obs import NULL_OBS
from . import ranking as R
from .clusters import (ClusterIndex, ClusterView, host_result, leaf,
                       pack_sig_words)


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One immutable published state; everything a query touches."""
    version: int              # publish counter (1-based, monotonic)
    stream_version: int       # miner writes covered by this snapshot
    result: Any               # the engine's PipelineResult, as the
                              # miner returned it (None on a shared-
                              # memory replica — queries never touch it)
    index: ClusterIndex
    querier: R.BatchQuerier   # ranked scalar/batch lookups + signatures
    ages: np.ndarray          # per-cluster age in versions (recency)
    published_at: float       # time.monotonic() at swap
    published_wall: float = 0.0   # time.time() at swap — cross-process
                                  # staleness (/health staleness_s)


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Hits plus the exact snapshot identity they were answered from."""
    version: int
    stream_version: int
    hits: Any      # [(ClusterView, score)] — or one such list per entity


def snapshot_query(snap: Snapshot, entity: Optional[int] = None,
                   mode: Optional[int] = None,
                   signature: Optional[Tuple[int, int]] = None,
                   k: int = 10) -> List[Tuple[ClusterView, float]]:
    """Ranked lookup against one snapshot — the query logic shared by
    the in-process service and shared-memory replica readers
    (``serve.shm.ReplicaService``), so both answer bit-identically.

    ``signature=(lo, hi)``: exact resolution (≤ 1 hit, score attached).
    ``entity=e [, mode=m]``: top-``k`` by the snapshot's scores.
    Neither: the snapshot's global top-``k``."""
    if signature is not None:
        row = int(snap.querier.lookup_signatures([signature])[0])
        hits: List[Tuple[ClusterView, float]] = []
        if row >= 0:
            view = snap.index.view_at(row)
            if entity is None or view.contains(int(entity), mode):
                hits = [(view, float(snap.querier.scores[row]))]
        return hits
    if entity is not None:
        return snap.querier.topk(int(entity), mode, k)
    return R.top_from_scores(snap.index, snap.querier.scores, k)


def snapshot_query_batch(snap: Snapshot, entities,
                         mode: Optional[int] = None, k: int = 10):
    """Batched twin of :func:`snapshot_query` (one stacked-window
    pass; ``hits[i]`` equals the scalar hits for ``entities[i]``)."""
    return snap.querier.topk_batch(entities, mode, k)


class TriclusterService:
    """Long-lived serving front-end over one streaming-capable miner.

    Lifecycle: construct, ``add`` initial data, ``start()`` (publishes
    the first snapshot synchronously and starts the re-mine thread),
    serve, ``stop()``.  Usable as a context manager.
    """

    def __init__(self, sizes: Sequence[int], *, backend: str = "streaming",
                 theta: float = 0.0, delta: Optional[float] = None,
                 rho_min: float = 0.0, minsup: int = 0, seed: int = 0x5EED,
                 refresh_interval: float = 0.25, dirty_threshold: int = 64,
                 policy: R.RankingPolicy = R.DEFAULT_POLICY,
                 min_density: float = 0.0, recency_horizon: int = 512,
                 delta_index: bool = True, publisher=None,
                 recover_dir: Optional[str] = None,
                 checkpoint_every: int = 64, fsync_wal: bool = False,
                 version_base: int = 0, fault=None,
                 scrub_interval: float = 0.5,
                 event_dir: Optional[str] = None,
                 event_name: str = "writer",
                 obs=None,
                 mesh=None, miner=None, **miner_kw):
        self.sizes = tuple(int(s) for s in sizes)
        self.refresh_interval = float(refresh_interval)
        self.dirty_threshold = max(1, int(dirty_threshold))
        #: delta-maintain the ClusterIndex across swaps (diff by packed
        #: signature, splice only dirty clusters — serve.clusters);
        #: False forces a full ``from_result`` rebuild every swap (the
        #: oracle / benchmark baseline)
        self.delta_index = bool(delta_index)
        #: optional ``serve.shm.ShmPublisher`` — every published
        #: snapshot is mirrored into shared memory for replica readers
        self.publisher = publisher
        #: versions a vanished signature keeps its first-seen record;
        #: past it the record is evicted (bounded memory on churning
        #: streams) and a re-emerging cluster counts as fresh again
        self.recency_horizon = max(1, int(recency_horizon))
        self.policy = policy
        self.min_density = float(min_density)
        if miner is not None:
            self.miner = miner
        elif backend == "streaming":
            from ..core.streaming import StreamingMiner
            self.miner = StreamingMiner(self.sizes, theta=theta, delta=delta,
                                        rho_min=rho_min, minsup=minsup,
                                        seed=seed, **miner_kw)
        elif backend == "distributed":
            from ..core.distributed import DistributedMiner
            if mesh is None:
                from ..launch.mesh import make_local_mesh
                mesh = make_local_mesh(device=miner_kw.get("device"))
            self.miner = DistributedMiner(self.sizes, mesh, theta=theta,
                                          delta=delta, rho_min=rho_min,
                                          minsup=minsup, seed=seed,
                                          **miner_kw)
        else:
            raise ValueError(f"backend must be 'streaming' or "
                             f"'distributed', got {backend!r}")
        # the distributed serving path needs the windowed full-table
        # result; the streaming snapshot already is one
        self._mine = getattr(self.miner, "serving_snapshot",
                             getattr(self.miner, "snapshot"))
        # per-snapshot dirty-signature sets (core.streaming /
        # core.distributed): surfaces the delta-index workload as the
        # ``dirty_clusters`` backlog in stats//health
        if hasattr(self.miner, "track_dirty_sigs"):
            self.miner.track_dirty_sigs = True
        self._ingest = getattr(self.miner, "ingest", None) or self.miner.add
        #: the device the miner's tensors live on, with its index: the
        #: re-mine thread makes it current (a bare "cuda" would mean
        #: that thread's own current device)
        lanes = getattr(self.miner, "_lo", None)
        self.device = (lanes[0].device if lanes
                       else torch.device(getattr(self.miner, "device",
                                                 "cpu")))
        #: fault injector (``serve.faults``) — fires the ``write`` site
        #: with every new stream version; shared with the publisher's
        #: ``publish``/``torn`` sites unless it carries its own
        self._fault = fault
        if (fault is not None and publisher is not None
                and getattr(publisher, "fault", None) is None):
            publisher.fault = fault
        #: publish-version floor: the first published snapshot gets
        #: ``version_base + 1``, so a restarted writer's versions (and
        #: the read-your-writes tokens minted before the crash) stay
        #: monotone across the restart
        self.version_base = max(0, int(version_base))
        #: durable recovery (``recover_dir``): every write is appended
        #: to a WAL *before* it is applied; on publish cadence the run
        #: store's checkpoint blob is persisted (atomic replace) and the
        #: WAL truncated to the tail it does not cover.  Construction
        #: with an existing recover_dir restores + replays (see
        #: :meth:`_recover`).
        self.recover_dir = recover_dir
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.fsync_wal = bool(fsync_wal)
        self._wal = None
        self._writes_since_ckpt = 0
        self._recovered = {}
        #: background scrubber cadence (s); 0 disables the thread.  The
        #: scrubber walks each newly published snapshot verifying
        #: cross-structure invariants (see :meth:`scrub`)
        self.scrub_interval = float(scrub_interval)
        self._scrub_thread: Optional[threading.Thread] = None
        #: integrity events are mirrored to ``{event_dir}/{event_name}
        #: .events`` for the supervisor to adopt into its log
        #: (``serve.supervise.write_event``); None keeps them local
        self.event_dir = event_dir
        self.event_name = event_name
        self._wlock = threading.Lock()      # miner store + dirty counter
        self._remine_lock = threading.Lock()  # one re-mine at a time
        self._cv = threading.Condition()    # snapshot publication + waits
        self._snap: Optional[Snapshot] = None
        self._dirty = 0
        self._first_seen: dict = {}   # signature -> [first_v, last_seen_v]
        self._last_mine = 0.0
        self._stop_evt = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stats = {"writes": 0, "publishes": 0, "mine_errors": 0,
                       "last_mine_ms": 0.0, "total_mine_ms": 0.0,
                       "delta_builds": 0, "full_builds": 0,
                       "last_index_build_ms": 0.0, "publish_errors": 0,
                       "checkpoints": 0, "wal_records": 0,
                       "recovered_ops": 0,
                       # integrity plane (DESIGN.md §9, fail-silent half)
                       "wal_crc_errors": 0, "wal_torn_tail": 0,
                       "wal_quarantined": 0, "checkpoint_quarantined": 0,
                       "checkpoint_generation_fallbacks": 0,
                       "scrubs": 0, "scrub_errors": 0,
                       "last_scrub_ms": 0.0, "last_scrub_version": 0,
                       "scrub_violations": []}
        #: observability hub (DESIGN.md §11): swap-path timings land in
        #: its histograms, and ``_stats`` is folded into /metrics via a
        #: scrape-time collector — the dict stays the single source,
        #: the registry renders it
        self.obs = obs if obs is not None else NULL_OBS
        if self.obs.enabled:
            self.obs.metrics.register_collector(self._collect_metrics)
            # per-stage pipeline profiling rides the same hub (the
            # miner's hook is duck-typed; see core.pipeline)
            if hasattr(self.miner, "obs"):
                self.miner.obs = self.obs
        if self.recover_dir:
            self._recover()

    # -- durable recovery (checkpoint + WAL) ---------------------------------

    @property
    def _ckpt_path(self) -> str:
        return os.path.join(self.recover_dir, "ckpt.npz")

    @property
    def _ckpt_prev_path(self) -> str:
        # previous checkpoint generation (N=2 policy): rotated into
        # place right before a new blob is persisted, so a corrupt or
        # torn current generation always has a verified fallback
        return os.path.join(self.recover_dir, "ckpt.prev.npz")

    @property
    def _wal_path(self) -> str:
        return os.path.join(self.recover_dir, "wal.jsonl")

    def _quarantine(self, path: str) -> str:
        """Move a poisoned file aside as ``{path}.quarantine.<epoch>``
        (never clobbering an earlier quarantine) and return the new
        path — the evidence survives for post-mortem, and recovery
        never re-reads it."""
        epoch = int(time.time())
        q = f"{path}.quarantine.{epoch}"
        n = 0
        while os.path.exists(q):
            n += 1
            q = f"{path}.quarantine.{epoch}.{n}"
        os.replace(path, q)
        return q

    def _integrity_event(self, event: str, detail: str) -> None:
        """Record a corruption/scrub event locally and mirror it to the
        supervisor's event log when this writer runs supervised."""
        self._stats.setdefault("integrity_events", []).append(
            [event, detail])
        if self.event_dir:
            try:
                from .supervise import write_event
                write_event(self.event_dir, self.event_name, event,
                            detail)
            except Exception:   # noqa: BLE001 — reporting must never
                pass            # take the data path down

    def _wal_append(self, op: str, rows, values, sv: int) -> None:
        if self._wal is None:
            self._wal = open(self._wal_path, "a", encoding="utf-8")
        rec = {"op": op, "rows": np.asarray(rows).tolist(), "sv": int(sv)}
        if values is not None:
            rec["values"] = np.asarray(values, np.float64).tolist()
        payload = json.dumps(rec)
        crc = zlib.crc32(payload.encode("utf-8"))
        if self._fault is not None:
            f = self._fault.corrupt("wal", int(sv))
            if f is not None:
                # injected bit rot *after* the CRC was taken: the
                # in-memory apply proceeds untouched, only replay-time
                # verification can tell this record is a lie
                i = len(payload) // 2
                payload = (payload[:i] + chr(ord(payload[i]) ^ 0x01)
                           + payload[i + 1:])
        self._wal.write(f"{crc:08x} {payload}\n")
        self._wal.flush()
        if self.fsync_wal:
            os.fsync(self._wal.fileno())
        self._stats["wal_records"] += 1

    def _checkpoint_locked(self, version: int) -> bool:
        """Persist the run store (atomic, CRC-framed) and truncate the
        WAL to the uncovered tail; the prior blob is rotated to the
        previous generation first.  Caller holds ``_wlock``.  Returns
        False when the miner has no checkpointable run store (then the
        WAL alone carries the whole stream — recovery replays from
        op 1)."""
        state = getattr(self.miner, "state", None)
        if not isinstance(state, RS.RunStore):
            return False
        sv = int(self.miner.stream_version)
        if os.path.exists(self._ckpt_path):
            os.replace(self._ckpt_path, self._ckpt_prev_path)
        RS.save_checkpoint(state.checkpoint(), self._ckpt_path,
                           meta={"stream_version": sv,
                                 "version": int(version)})
        if self._fault is not None:
            f = self._fault.corrupt("checkpoint", int(version))
            if f is not None:
                # injected truncation of the just-persisted blob: the
                # frame header survives but promises more bytes than
                # the file holds — load must reject, recovery must
                # fall back to the rotated previous generation
                size = os.path.getsize(self._ckpt_path)
                with open(self._ckpt_path, "r+b") as fh:
                    fh.truncate(max(1, size // 2))
        # the checkpoint covers every op ≤ sv: start a fresh WAL
        if self._wal is not None:
            self._wal.close()
            self._wal = None
        with open(self._wal_path, "w", encoding="utf-8"):
            pass
        self._writes_since_ckpt = 0
        self._stats["checkpoints"] += 1
        return True

    def final_checkpoint(self) -> bool:
        """Graceful-shutdown hook: persist the store so the next boot
        restores instead of replaying (no-op without a recover_dir)."""
        if not self.recover_dir:
            return False
        with self._wlock:
            return self._checkpoint_locked(self.version)

    @staticmethod
    def _parse_wal_line(raw: bytes) -> Optional[dict]:
        """One WAL line → its record, or ``None`` when the frame fails
        verification (bit rot / torn write).  Framed lines are
        ``crc32-hex SP json``; legacy unframed JSON lines verify by
        parse alone."""
        try:
            s = raw.decode("utf-8")
        except UnicodeDecodeError:
            return None
        if len(s) > 9 and s[8] == " ":
            try:
                crc = int(s[:8], 16)
            except ValueError:
                crc = None
            if crc is not None:
                payload = s[9:]
                if zlib.crc32(payload.encode("utf-8")) != crc:
                    return None
                try:
                    return json.loads(payload)
                except json.JSONDecodeError:
                    return None
        if s.lstrip().startswith("{"):
            try:
                return json.loads(s)
            except json.JSONDecodeError:
                return None
        return None

    def _recover(self) -> None:
        """Restore the store from the newest *verified* checkpoint
        generation, replay the verified WAL prefix through the miner,
        and floor the publish version — the crashed predecessor's
        writes and read-your-writes tokens survive into this
        incarnation.

        Corruption handling (DESIGN.md §9): a checkpoint generation
        that fails its CRC frame is quarantined and recovery falls back
        to the previous generation (bounding data loss to the ops
        between the two).  A WAL whose *last* record fails is torn —
        truncate to the verified prefix and resume in place.  A WAL
        with verified records *after* a failed one is poisoned — the
        ordering across the lost record is unknowable, so the whole
        file is quarantined, the verified prefix replayed, and a fresh
        checkpoint cut so the prefix stays durable."""
        os.makedirs(self.recover_dir, exist_ok=True)
        ckpt_sv = 0
        ckpt_gen = ""
        for path, gen in ((self._ckpt_path, "current"),
                          (self._ckpt_prev_path, "previous")):
            if not os.path.exists(path):
                continue
            try:
                blob, meta = RS.load_checkpoint(path)
                store = RS.RunStore.restore(blob)
            except Exception as e:  # noqa: BLE001 — CRC frame, torn
                # zip, or un-restorable blob: all poison this
                # generation; quarantine it and fall back
                q = self._quarantine(path)
                self._stats["checkpoint_quarantined"] += 1
                self._integrity_event(
                    "checkpoint_quarantined",
                    f"{gen} generation unreadable ({e!r}); "
                    f"-> {os.path.basename(q)}")
                continue
            self.miner.state = store
            ckpt_sv = int(meta.get("stream_version", 0))
            ckpt_gen = gen
            self.miner.stream_version = ckpt_sv
            self.version_base = max(self.version_base,
                                    int(meta.get("version", 0)))
            # re-adopt plans/stats (and validate) through the miner
            if hasattr(self.miner, "_store"):
                self.miner._store()
            break
        if ckpt_gen == "previous":
            self._stats["checkpoint_generation_fallbacks"] += 1
            self._integrity_event(
                "checkpoint_generation_fallback",
                f"restored previous generation at sv={ckpt_sv}")
        replayed = 0
        wal_quarantined = ""
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                raw = f.read()
            entries: List[Tuple[int, bytes]] = []
            off = 0
            for ln in raw.split(b"\n"):
                entries.append((off, ln))
                off += len(ln) + 1
            recs: List[Tuple[int, dict]] = []
            bad: List[Tuple[int, int]] = []      # (line no, byte offset)
            for i, (o, ln) in enumerate(entries):
                if not ln.strip():
                    continue
                rec = self._parse_wal_line(ln)
                if rec is None:
                    bad.append((i, o))
                else:
                    recs.append((i, rec))
            cut = len(entries)
            if bad:
                first_bad, bad_off = bad[0]
                self._stats["wal_crc_errors"] += len(bad)
                cut = first_bad
                if any(i > first_bad for i, _ in recs):
                    # interior poison: verified records beyond the rot
                    # exist, but their ordering against the lost op is
                    # unknowable — quarantine the whole file, keep the
                    # verified prefix
                    wal_quarantined = self._quarantine(self._wal_path)
                    self._stats["wal_quarantined"] += 1
                    self._integrity_event(
                        "wal_quarantined",
                        f"interior record corrupt at line "
                        f"{first_bad + 1}; -> "
                        f"{os.path.basename(wal_quarantined)}")
                else:
                    # torn tail: the crash interrupted the last append;
                    # drop the half-record, resume appending in place
                    self._stats["wal_torn_tail"] += 1
                    with open(self._wal_path, "r+b") as f:
                        f.truncate(bad_off)
                    self._integrity_event(
                        "wal_torn_tail",
                        f"truncated to {bad_off} bytes "
                        f"(line {first_bad + 1} torn)")
            for i, rec in recs:
                if i >= cut:
                    continue
                if int(rec.get("sv", 0)) <= ckpt_sv:
                    continue
                rows = np.asarray(rec["rows"])
                vals = rec.get("values")
                op = rec.get("op", "add")
                if op == "delete":
                    self.miner.delete(rows)
                elif op == "upsert":
                    self.miner.upsert(rows, vals)
                else:
                    self._ingest(rows, vals)
                # replay lands exactly at the logged version even
                # if an op maps to a different number of bumps
                self.miner.stream_version = int(rec["sv"])
                replayed += 1
        self._stats["recovered_ops"] = replayed
        if wal_quarantined:
            # the quarantined file no longer backs the replayed prefix:
            # cut a checkpoint now so those ops survive the next crash
            try:
                with self._wlock:
                    self._checkpoint_locked(self.version_base)
            except Exception as e:  # noqa: BLE001 — recovery proceeds;
                # worst case the prefix replays again from older state
                self._stats["checkpoint_errors"] = \
                    self._stats.get("checkpoint_errors", 0) + 1
                self._stats["last_checkpoint_error"] = repr(e)
        if (ckpt_sv or replayed or wal_quarantined
                or self._stats["checkpoint_quarantined"]):
            if ckpt_sv or replayed:
                self._dirty = 1              # force a publish on start()
            self._recovered = {
                "checkpoint_stream_version": ckpt_sv,
                "checkpoint_generation": ckpt_gen or "none",
                "replayed_ops": replayed,
                "stream_version": self.miner.stream_version,
                "version_base": self.version_base,
                "wal_crc_errors": self._stats["wal_crc_errors"],
                "wal_torn_tail": self._stats["wal_torn_tail"],
                "wal_quarantined": (os.path.basename(wal_quarantined)
                                    if wal_quarantined else ""),
                "checkpoint_quarantined":
                    self._stats["checkpoint_quarantined"]}

    # -- background scrubber (integrity plane) -------------------------------

    def scrub(self, snap: Optional[Snapshot] = None) -> dict:
        """Walk one published snapshot verifying the cross-structure
        invariants that tie index, result, ranking and store together
        (DESIGN.md §9): the index carries exactly ``result.keep``'s
        signatures, packed signatures are sorted, the overlay lut is a
        consistent bijection over live rows, run keys are monotone, and
        every score/age is finite.  Violations mean a structure was
        mutated after publish (or built from corrupt inputs) — they are
        recorded in stats and flip ``scrub_clean`` so ``/health`` goes
        503 and the balancer stops routing here."""
        snap = self._snap if snap is None else snap
        if snap is None:
            return {"version": 0, "violations": [], "ms": 0.0}
        t0 = time.perf_counter()
        v: List[str] = []
        idx = snap.index
        ps = getattr(idx, "packed_sigs", None)
        if ps is not None and ps.size > 1 and not bool(
                np.all(ps[:-1] <= ps[1:])):
            v.append("index packed_sigs not sorted")
        res = snap.result
        if res is not None and ps is not None:
            keep = leaf(res, "keep").astype(bool)
            if self.min_density:
                keep = keep & (leaf(res, "density") >= self.min_density)
            want = np.sort(pack_sig_words(leaf(res, "sig_lo")[keep],
                                          leaf(res, "sig_hi")[keep]))
            if want.size != ps.size or not bool(np.array_equal(want,
                                                               ps)):
                v.append(f"index/result divergence: index carries "
                         f"{ps.size} signatures, result.keep "
                         f"{want.size} (or contents differ)")
        lut = getattr(idx, "_lut", None)
        if lut is not None and len(idx):
            id_of_row = getattr(idx, "_id_of_row", None)
            live = lut[lut >= 0]
            if live.size != len(idx) or not bool(np.array_equal(
                    np.sort(live), np.arange(len(idx)))):
                v.append("overlay lut is not a bijection onto rows")
            elif id_of_row is not None and not bool(np.array_equal(
                    lut[id_of_row], np.arange(len(idx)))):
                v.append("overlay lut/id_of_row not inverse")
        sc = getattr(snap.querier, "scores", None)
        if sc is not None and not bool(np.all(np.isfinite(sc))):
            v.append("non-finite ranking scores")
        if snap.ages is not None and not bool(
                np.all(np.isfinite(np.asarray(snap.ages)))):
            v.append("non-finite cluster ages")
        state = getattr(self.miner, "state", None)
        if isinstance(state, RS.RunStore):
            with self._wlock:
                runs = list(state.runs)
            for r in runs:
                if any(k.size > 1 and not bool(np.all(k[:-1] <= k[1:]))
                       for k in r.keys):
                    v.append("run store: sorted-run keys not monotone")
                    break
        ms = (time.perf_counter() - t0) * 1e3
        self._stats["scrubs"] += 1
        self._stats["last_scrub_ms"] = ms
        self._stats["last_scrub_version"] = snap.version
        if self.obs.enabled:
            self.obs.metrics.histogram("service_scrub_ms").observe(ms)
        if v:
            self._stats["scrub_errors"] += len(v)
            self._stats["scrub_violations"] = v   # rebind, never mutate
            for msg in v:
                self._integrity_event("scrub_violation",
                                      f"v{snap.version}: {msg}")
        return {"version": snap.version, "violations": v, "ms": ms}

    def _scrub_loop(self):
        last = -1
        while not self._stop_evt.is_set():
            snap = self._snap
            if snap is not None and snap.version != last:
                try:
                    self.scrub(snap)
                    last = snap.version
                except Exception as e:  # noqa: BLE001 — the scrubber
                    # must survive anything; a scrub crash is itself
                    # recorded, never fatal
                    self._stats["scrub_errors"] += 1
                    self._stats["last_scrub_error"] = repr(e)
                    last = snap.version
            self._stop_evt.wait(max(self.scrub_interval, 1e-3))

    @property
    def scrub_clean(self) -> bool:
        """False once the scrubber found an invariant violation — the
        /health 503 condition for silent corruption."""
        return not self._stats["scrub_violations"]

    def resilience_stats(self) -> dict:
        """Integrity/recovery counters: the scrubber + quarantine
        surface (mirrors the router's ``resilience_stats`` contract)."""
        s = self._stats
        return {k: s[k] for k in (
            "scrubs", "scrub_errors", "last_scrub_ms",
            "last_scrub_version", "scrub_violations", "wal_crc_errors",
            "wal_torn_tail", "wal_quarantined",
            "checkpoint_quarantined",
            "checkpoint_generation_fallbacks")}

    # -- writer path ---------------------------------------------------------

    def _write(self, op, rows, values=None, name: str = "add") -> int:
        with self._wlock:
            if self.recover_dir:
                # write-ahead: the record is durable before the store
                # mutates, so a crash at any later point replays it
                self._wal_append(name, rows, values,
                                 self.miner.stream_version + 1)
                self._writes_since_ckpt += 1
            if values is None:
                op(rows)
            else:
                op(rows, values)
            self._dirty += 1
            self._stats["writes"] += 1
            v = self.miner.stream_version
        self._wake.set()
        if self.publisher is not None:
            try:                       # advisory backlog slot (no swap)
                self.publisher.update_dirty(self._dirty)
            except Exception:          # noqa: BLE001 — never fail a write
                pass
        if self._fault is not None:
            self._fault.fire("write", v)
        return v

    def add(self, rows, values=None) -> int:
        """Append a chunk; returns the miner's new stream_version."""
        return self._write(self._ingest, rows, values, name="add")

    def upsert(self, rows, values=None) -> int:
        return self._write(self.miner.upsert, rows, values, name="upsert")

    def delete(self, rows) -> int:
        return self._write(self.miner.delete, rows, name="delete")

    @property
    def recovered(self) -> dict:
        """Recovery summary when this service restored a predecessor's
        checkpoint/WAL at construction; empty on a fresh boot."""
        return dict(self._recovered)

    @property
    def dirty(self) -> int:
        """Writes not yet covered by the published snapshot."""
        return self._dirty

    @property
    def stream_version(self) -> int:
        return self.miner.stream_version

    @property
    def version(self) -> int:
        """Version of the currently published snapshot (0: none yet)."""
        snap = self._snap
        return 0 if snap is None else snap.version

    @property
    def dirty_clusters(self) -> int:
        """Clusters whose signature changed at the last snapshot (the
        miner's per-snapshot dirty-signature set — the delta-index
        workload)."""
        return int(getattr(self.miner, "last_dirty_sigs", 0))

    def staleness_s(self) -> float:
        """Seconds since the current snapshot was published (inf before
        the first publish) — the /health freshness signal."""
        snap = self._snap
        if snap is None:
            return float("inf")
        return max(0.0, time.monotonic() - snap.published_at)

    @property
    def thread_alive(self) -> bool:
        """False only when the re-mine thread was started and died (it
        is written to survive exceptions, so death means something
        catastrophic) — the /health 503 condition."""
        if not getattr(self, "_started", False) or self._stop_evt.is_set():
            return True
        t = self._thread
        return t is not None and t.is_alive()

    def stats(self) -> dict:
        out = dict(self._stats)
        snap = self._snap
        out.update(version=self.version, dirty=self._dirty,
                   stream_version=self.miner.stream_version,
                   clusters=0 if snap is None else len(snap.index),
                   dirty_clusters=self.dirty_clusters,
                   staleness_s=self.staleness_s(),
                   thread_alive=self.thread_alive,
                   sizes=list(self.sizes))
        if self._recovered:
            out["recovered"] = dict(self._recovered)
        return out

    def _collect_metrics(self):
        """Scrape-time collector: every numeric ``stats()`` entry as a
        ``service_<key>{role=...}`` gauge — /stats and /metrics render
        the same counters from the same dict."""
        role = "replica" if getattr(self, "read_only", False) \
            else "writer"
        for k, val in self.stats().items():
            yield f"service_{k}", {"role": role}, val

    # -- mining / publication ------------------------------------------------

    def refresh(self) -> Snapshot:
        """Synchronously mine + publish a new snapshot (even when clean:
        an explicit refresh always advances the version, giving callers
        a version number that provably covers their writes)."""
        return self._remine(force=True)

    def _on_device(self):
        """Make the miner's device current in the calling thread."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _remine(self, force: bool = False) -> Snapshot:
        with self._remine_lock, self._on_device():
            snap = self._snap
            if not force and snap is not None and self._dirty == 0:
                return snap
            t0 = time.perf_counter()
            # no-op span when tracing is off; covers the whole swap
            sp = self.obs.tracer.start("service.swap")
            with self._wlock:
                # the store mutates under snapshot() (compaction/merge):
                # writers hold off while we mine, readers don't care
                covered = self.miner.stream_version
                result = self._mine()
                # the readback is the block: every leaf the index needs
                # comes back to the host once, and a CUDA copy waits for
                # the mine it reads
                t_rb = time.perf_counter()
                host = host_result(result)
                readback_ms = (time.perf_counter() - t_rb) * 1e3
                self._dirty = 0
            mine_ms = (time.perf_counter() - t0) * 1e3
            # index + ranking build off the writer path: writes land
            # freely while we stack windows host-side.  Delta path: diff
            # against the previous snapshot's index by packed signature
            # and splice only dirty clusters — O(changed), the
            # swap-critical-path optimisation; full from_result stays
            # the oracle (and the fallback for the first snapshot)
            t1 = time.perf_counter()
            prev = self._snap
            if (self.delta_index and prev is not None
                    and prev.index.supports_delta):
                index = ClusterIndex.delta_from_result(
                    prev.index, host, min_density=self.min_density)
                self._stats["delta_builds"] += 1
                build_kind = "delta"
            else:
                index = ClusterIndex.from_result(
                    host, min_density=self.min_density)
                self._stats["full_builds"] += 1
                build_kind = "full"
            build_ms = (time.perf_counter() - t1) * 1e3
            self._stats["last_index_build_ms"] = build_ms
            version = (self.version_base if self._snap is None
                       else self._snap.version) + 1
            fs = self._first_seen
            ages = []
            # signature keys straight off the stats arrays — this loop
            # must not force the index's lazy view list (that would
            # re-introduce the O(clusters) build the delta path removed)
            for sig in index.signature_keys():
                rec = fs.get(sig)
                if rec is None:
                    fs[sig] = rec = [version, version]
                else:
                    rec[1] = version
                ages.append(version - rec[0])
            ages = np.asarray(ages, np.float64)
            # evict first-seen records of long-vanished signatures
            # (sweep only when the map clearly outgrew the live set)
            if len(fs) > 2 * len(index) + 1024:
                cut = version - self.recency_horizon
                for sig in [s for s, r in fs.items() if r[1] < cut]:
                    del fs[sig]
            querier = R.BatchQuerier(index, self.policy, ages)
            snap = Snapshot(version=version, stream_version=covered,
                            result=result, index=index, querier=querier,
                            ages=ages, published_at=time.monotonic(),
                            published_wall=time.time())
            # mirror into shared memory BEFORE the in-process swap: by
            # the time a writer-side call (refresh/upsert+wait) returns
            # version v, the shm side already carries v — so a client
            # that then demands at_least_version=v from a replica can
            # only block on the replica's attach latency, never on an
            # unpublished segment
            shm_publish_ms = 0.0
            if self.publisher is not None:
                t2 = time.perf_counter()
                try:
                    self.publisher.publish_snapshot(snap, sizes=self.sizes)
                    self.publisher.update_dirty(self._dirty)
                except Exception as e:        # noqa: BLE001 — serving
                    # must outlive a publish failure; replicas just stay
                    # on the previous segment
                    self._stats["publish_errors"] += 1
                    self._stats["last_publish_error"] = repr(e)
                shm_publish_ms = (time.perf_counter() - t2) * 1e3
                self._stats["last_shm_publish_ms"] = shm_publish_ms
            self._last_mine = time.monotonic()
            self._stats["publishes"] += 1
            self._stats["last_mine_ms"] = mine_ms
            self._stats["total_mine_ms"] += mine_ms
            with self._cv:
                self._snap = snap            # THE atomic swap
                self._cv.notify_all()
            if self.obs.enabled:
                # swap-path profile (DESIGN.md §11): one histogram per
                # stage of the publish — mine, index build (delta vs
                # full), shm mirror, end-to-end — plus the span opened
                # at swap entry, carrying the per-stage split
                m = self.obs.metrics
                swap_ms = (time.perf_counter() - t0) * 1e3
                m.histogram("service_mine_ms").observe(mine_ms)
                m.histogram("service_index_build_ms",
                            kind=build_kind).observe(build_ms)
                if self.publisher is not None:
                    m.histogram("service_shm_publish_ms").observe(
                        shm_publish_ms)
                m.histogram("service_swap_ms").observe(swap_ms)
                sp.set("version", version).set("build", build_kind)
                sp.set("mine_ms", mine_ms)
                sp.set("index_build_ms", build_ms)
                sp.set("shm_publish_ms", shm_publish_ms)
                sp.set("readback_ms", readback_ms)
                sp.set("readback_bytes", host.nbytes)
            sp.finish()
            # durable checkpoint on publish cadence: the blob covers
            # everything this snapshot covers, the WAL shrinks to the
            # writes that landed during the mine
            if (self.recover_dir
                    and self._writes_since_ckpt >= self.checkpoint_every):
                try:
                    with self._wlock:
                        self._checkpoint_locked(version)
                except Exception as e:       # noqa: BLE001 — serving
                    # must outlive a checkpoint failure (disk full…);
                    # recovery falls back to a longer WAL replay
                    self._stats["checkpoint_errors"] = \
                        self._stats.get("checkpoint_errors", 0) + 1
                    self._stats["last_checkpoint_error"] = repr(e)
            return snap

    def _loop(self):
        while not self._stop_evt.is_set():
            self._wake.wait(timeout=max(self.refresh_interval, 1e-3))
            if self._stop_evt.is_set():
                break
            self._wake.clear()
            with self._wlock:
                dirty = self._dirty
            due = dirty >= self.dirty_threshold or (
                dirty > 0 and time.monotonic() - self._last_mine
                >= self.refresh_interval)
            if due:
                try:
                    self._remine()
                except Exception as e:   # noqa: BLE001 — the refresh
                    # thread must survive anything (a deleted-empty
                    # stream, a transient device error): keep serving the
                    # last published snapshot and record the failure
                    # instead of silently dying ever-staler
                    self._stats["mine_errors"] += 1
                    self._stats["last_mine_error"] = repr(e)

    def start(self) -> "TriclusterService":
        """Publish the initial snapshot (if any data is ingested) and
        start the background re-mine thread."""
        if self._thread is not None:
            return self
        try:
            self._remine(force=True)
        except ValueError:
            pass                              # no data yet: first write mines
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="tricluster-remine",
                                        daemon=True)
        self._thread.start()
        if self.scrub_interval > 0 and self._scrub_thread is None:
            self._scrub_thread = threading.Thread(
                target=self._scrub_loop, name="tricluster-scrub",
                daemon=True)
            self._scrub_thread.start()
        self._started = True
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self._scrub_thread is not None:
            self._scrub_thread.join(timeout=30)
            self._scrub_thread = None
        if self.device.type == "cuda":
            # nothing a re-mine queued outlives the service
            torch.cuda.synchronize(self.device)
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    def __enter__(self) -> "TriclusterService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- reader path ---------------------------------------------------------

    def snapshot(self, at_least_version: Optional[int] = None,
                 timeout: Optional[float] = None) -> Snapshot:
        """The current snapshot — one reference read, never blocking on
        mining.  ``at_least_version`` switches freshness mode: wait (up
        to ``timeout`` seconds) until a snapshot with that version or
        newer is published, then return it."""
        snap = self._snap
        if at_least_version is None:
            if snap is None:
                raise RuntimeError("no snapshot published yet — ingest "
                                   "data and start()/refresh() first")
            return snap
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._snap is None or \
                    self._snap.version < at_least_version:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"version {at_least_version} not published within "
                        f"{timeout}s (current: {self.version})")
                self._cv.wait(timeout=remaining)
            return self._snap

    def query(self, entity: Optional[int] = None,
              mode: Optional[int] = None,
              signature: Optional[Tuple[int, int]] = None,
              k: int = 10, at_least_version: Optional[int] = None,
              timeout: Optional[float] = None) -> QueryResult:
        """Ranked lookup against one consistent snapshot.

        ``signature=(lo, hi)``: exact resolution (≤ 1 hit, score
        attached).  ``entity=e [, mode=m]``: top-``k`` by the ranking
        policy.  Neither: the snapshot's global top-``k``."""
        snap = self.snapshot(at_least_version, timeout)
        hits = snapshot_query(snap, entity=entity, mode=mode,
                              signature=signature, k=k)
        return QueryResult(snap.version, snap.stream_version, hits)

    def query_batch(self, entities, mode: Optional[int] = None,
                    k: int = 10, at_least_version: Optional[int] = None,
                    timeout: Optional[float] = None) -> QueryResult:
        """Vectorised multi-entity top-``k``: one stacked-window pass for
        the whole batch (``ranking.BatchQuerier.topk_batch``) against one
        consistent snapshot; ``hits[i]`` corresponds to ``entities[i]``
        and equals the scalar ``query(entity=entities[i])`` hits."""
        snap = self.snapshot(at_least_version, timeout)
        return QueryResult(snap.version, snap.stream_version,
                           snapshot_query_batch(snap, entities, mode, k))
