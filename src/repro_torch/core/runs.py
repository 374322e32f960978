"""Sorted-run storage layer: the one LSM-style structure under the
port's incremental and out-of-core paths.  Port of ``repro.core.runs``
(numpy only, like the original), on the port's own ``core.keys`` plans
and ``core.radix`` host sort.

The paper's online Algorithm 1 and its MapReduce variants reduce to the
same primitive — maintaining per-mode *sorted order* of the tuple table
incrementally instead of re-sorting it — and the engine features below
are built on exactly that primitive through this module:

* **streaming snapshots** (``core.streaming``): chunks are sorted on
  arrival, snapshots merge runs into full permutations;
* **out-of-core batch Stage 1** (``PipelineMiner.mine_chunked``): the
  table is sorted chunk-by-chunk on the host with O(chunk) working set,
  and the device pipeline receives the merged permutations instead of
  sorting; ``PipelineMiner.mine_windowed`` streams the same merged
  permutations through bounded device windows (``core.windowed``);
* the per-shard stores of the distributed backend (a later slice of
  the port) route rows with :func:`shard_of_rows` and merge with
  :func:`offset_run`.

A ``RunStore`` owns an append-only row log plus, per mode, a set of
sorted :class:`Run` s of packed key words (``core.keys`` plans — the
*same* bit layouts the device pipeline sorts by, so host-merged
permutations and device sorts order identically by construction):

* ``add(chunk)`` sorts **only the chunk** (O(c log c) per mode, host LSD
  radix from ``core.radix`` by default) into a new run, then compacts
  geometrically-sized runs by linear two-run merges — every tuple is
  merged O(log T) times over the store's lifetime.
* **Tombstones**: ``upsert(rows, values)`` and ``delete(rows)`` mark
  superseded log rows dead in an ``alive`` bitmap — the record itself
  is the tombstone, no sentinel keys enter the sorted order — giving
  last-write-wins semantics matching the batch constructor's
  canonicalisation (``core.context``: one row per distinct tuple, last
  value wins).  Valued ``add`` *is* ``upsert``, which lifts the
  historical value-consistency precondition on many-valued streams.
  Run merges drop dead entries; ``prepare()``/``compact()`` rewrite the
  log to the survivor set before a snapshot.
* ``prepare()`` folds the surviving runs into one per-mode permutation
  of the compacted survivor table (linear in T, no re-sort);
  ``perms(cap)`` pads it with duplicates of row 0 (idempotent under the
  mining algebra) to the snapshot length (:func:`snapshot_cap`).
* The whole state is numpy arrays: ``checkpoint()`` serialises the run
  arrays and tombstones themselves, so ``restore`` is O(T) array loads
  — no re-sort (old buffer-only blobs still restore via the lazy
  rebuild path: ``covered=0`` re-sorts once on resume).

Rows are identified (for upsert/delete) by an *entity-only* packed key
— mode 0's layout without the value lane — so versions of a tuple with
different values collapse onto one identity; contexts whose identity
key exceeds 64 bits fall back to row-byte keys.  Unvalued stores build
the identity index lazily on the first upsert/delete, so pure append
streams pay nothing for it; valued stores maintain it from the first
chunk (their adds ARE upserts) — an O(rows) host dict pass per chunk,
amortised once per row over the stream.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import keys as K
from . import radix as RX


@dataclasses.dataclass
class Run:
    """One sorted run: per-mode sorted packed keys + log-row indices."""
    keys: List[np.ndarray]   # per mode, (L,) uint64, ascending
    idx: List[np.ndarray]    # per mode, (L,) int32 indices into the log

    @property
    def size(self) -> int:
        return int(self.idx[0].shape[0])


def merge_runs(a: Run, b: Run) -> Run:
    """Linear stable merge of two sorted runs (a's elements win ties).
    Disjoint key ranges (e.g. radix-range-partitioned shards, mode 0)
    short-circuit to a concatenation."""
    keys, idx = [], []
    for ka, ia, kb, ib in zip(a.keys, a.idx, b.keys, b.idx):
        if ka.size == 0 or kb.size == 0 or ka[-1] <= kb[0]:
            keys.append(np.concatenate([ka, kb]))
            idx.append(np.concatenate([ia, ib]))
            continue
        if kb[-1] < ka[0]:          # strict: ties must keep a first
            keys.append(np.concatenate([kb, ka]))
            idx.append(np.concatenate([ib, ia]))
            continue
        pa = np.searchsorted(kb, ka, side="left") + np.arange(ka.size)
        pb = np.searchsorted(ka, kb, side="right") + np.arange(kb.size)
        mk = np.empty(ka.size + kb.size, np.uint64)
        mi = np.empty(ka.size + kb.size, np.int32)
        mk[pa], mk[pb] = ka, kb
        mi[pa], mi[pb] = ia, ib
        keys.append(mk)
        idx.append(mi)
    return Run(keys, idx)


def offset_run(run: Run, offset: int) -> Run:
    """The run with all log indices shifted (cross-store merges)."""
    if offset == 0:
        return run
    return Run(run.keys, [i + np.int32(offset) for i in run.idx])


def padded_perms(run: Run, plans: Sequence[K.ModeKeyPlan],
                 row0: np.ndarray, val0: Optional[np.ndarray],
                 count: int, cap: int) -> np.ndarray:
    """(N, cap) permutations from a full merged run over ``count`` rows,
    extended with pad indices [count, cap) at the sort positions of row
    0's key — pad rows are duplicates of row 0, idempotent under the
    mining algebra."""
    if cap == count:
        return np.stack(run.idx)
    pad_idx = np.arange(count, cap, dtype=np.int32)
    perms = []
    for plan, keys, idx in zip(plans, run.keys, run.idx):
        key0 = plan.pack_host(row0, val0)[0]
        pos = int(np.searchsorted(keys, key0, side="right"))
        perms.append(np.insert(idx, pos, pad_idx))
    return np.stack(perms)


def padded_table(rows: np.ndarray, values: Optional[np.ndarray],
                 cap: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(rows, values) extended to ``cap`` with duplicates of row 0 — the
    SAME pad rule :func:`padded_perms` assumes (pad indices are inserted
    at row 0's key positions), kept in one place so the table and perm
    sides can never drift."""
    pad = cap - rows.shape[0]
    if pad:
        rows = np.concatenate([rows, np.repeat(rows[:1], pad, 0)])
        if values is not None:
            values = np.concatenate([values, np.repeat(values[:1], pad)])
    return rows, values


def snapshot_cap(count: int, multiple: int = 1) -> int:
    """Snapshot length for a growing stream: the next power of two,
    rounded up to a multiple (shard divisibility) if needed.  The JAX
    package pads to it to bound recompiles (O(log T) over a stream's
    lifetime); the port keeps the same padding so that its snapshot
    results equal that package's leaf for leaf, pads included."""
    cap = 1 << max(0, int(np.ceil(np.log2(max(count, 1)))))
    if cap < count:
        cap *= 2
    if cap % multiple:
        cap = -(-cap // multiple) * multiple
    return cap


def shard_of_rows(rows: np.ndarray, id_plan: K.ModeKeyPlan,
                  n_shards: int) -> np.ndarray:
    """Owner shard per row from the *fixed* radix-range partition: the
    top ``HIST_DIGIT_BITS`` of the entity-only identity key's
    subrelation prefix, mapped uniformly onto shards — the same
    top-digit primitive the distributed shuffle's range partitioner
    runs on its pre-shuffle keys (``core.distributed``), applied on the
    host to route ingestion.  Deterministic per *tuple* (the identity
    key has no value lane), so every version of a row lands in the
    shard that holds its predecessors."""
    if n_shards <= 1:
        return np.zeros(rows.shape[0], np.int64)
    top_w = min(RX.HIST_DIGIT_BITS,
                max(1, id_plan.total_bits - id_plan.e_bits))
    keys = id_plan.pack_host(rows)
    dig = (keys >> np.uint64(id_plan.total_bits - top_w)).astype(np.int64)
    return (dig * n_shards) >> top_w


def iter_chunks(chunks, values=None, chunk_budget: Optional[int] = None,
                with_values: bool = False):
    """Normalise ``mine_chunked``-style input into (rows, values) chunk
    pairs: a single (T, N) array is split by ``chunk_budget``; an
    iterable of arrays is re-split whenever a chunk exceeds the budget.
    ``values`` may be None, a single (T,) array (aligned with a single
    table), or an iterable aligned with ``chunks``."""
    if isinstance(chunks, np.ndarray) or (
            hasattr(chunks, "shape") and getattr(chunks, "ndim", 0) == 2):
        chunks = [np.asarray(chunks)]
        if values is not None:
            values = [np.asarray(values)]
    chunk_list = [np.asarray(c, np.int32) for c in chunks]
    if values is None:
        value_list = [None] * len(chunk_list)
    else:
        value_list = [np.asarray(v, np.float32) for v in values]
        if len(value_list) != len(chunk_list):
            raise ValueError("values chunks must align with row chunks")
    for rows, vals in zip(chunk_list, value_list):
        rows = np.atleast_2d(rows)
        if with_values and vals is None:
            vals = np.zeros(rows.shape[0], np.float32)
        step = rows.shape[0] if not chunk_budget \
            else max(1, int(chunk_budget))
        for lo in range(0, rows.shape[0], step):
            hi = lo + step
            yield rows[lo:hi], None if vals is None else vals[lo:hi]


class RunStore:
    """Per-mode sorted-run storage of one (possibly valued) tuple log.

    ``plans`` are the context's ``core.keys`` bit-width plans (one per
    mode; ``plans[0].with_values`` decides whether the store carries a
    value column).  ``radix=True`` sorts chunks with the host LSD radix
    (``core.radix``), mirroring the device default; ``incremental=False``
    keeps only the log + tombstones (non-fitting keys: the caller
    re-sorts on device).  ``stats`` may be a shared dict — the store
    increments ``chunk_sorted_rows`` / ``merged_rows`` /
    ``tombstoned_rows`` / ``compacted_rows`` in place so engines expose
    one ledger."""

    def __init__(self, plans: Optional[Sequence[K.ModeKeyPlan]] = None,
                 radix: bool = True, incremental: bool = True,
                 stats: Optional[dict] = None):
        self.plans = tuple(plans) if plans is not None else None
        self.radix = bool(radix)
        self.incremental = bool(incremental) and (
            plans is None or all(p.fits for p in self.plans))
        self.rows = np.zeros((0, len(plans) if plans else 0), np.int32)
        self.values: Optional[np.ndarray] = None
        self.count = 0
        self.alive = np.zeros((0,), bool)
        self.dead = 0
        self.runs: List[Run] = []
        self.covered = 0
        self.stats = stats if stats is not None else {}
        self._index: Optional[dict] = None
        self._id_plan: Optional[K.ModeKeyPlan] = None

    # -- properties ---------------------------------------------------------

    @property
    def with_values(self) -> bool:
        return bool(self.plans and self.plans[0].with_values)

    @property
    def buffer(self) -> np.ndarray:
        """The row log (compat alias used by older callers)."""
        return self.rows

    def _bump(self, key: str, n: int) -> None:
        self.stats[key] = self.stats.get(key, 0) + int(n)

    # -- identity (upsert/delete keys) --------------------------------------

    def _identity_plan(self) -> K.ModeKeyPlan:
        if self._id_plan is None:
            self._id_plan = K.plan_mode_key(self.plans[0].sizes, 0,
                                            with_values=False)
        return self._id_plan

    def _identity(self, rows: np.ndarray):
        """Hashable per-row identity: entity-only packed key (the value
        lane is deliberately absent — all versions of a tuple collapse),
        or row bytes when the key exceeds 64 bits."""
        plan = self._identity_plan()
        if plan.fits:
            return plan.pack_host(rows).tolist()
        rows = np.ascontiguousarray(rows, np.int32)
        return [r.tobytes() for r in rows]

    def _ensure_index(self) -> dict:
        if self._index is None:
            idx: dict = {}
            live = np.nonzero(self.alive[:self.count])[0]
            for key, i in zip(self._identity(self.rows[live]),
                              live.tolist()):
                idx.setdefault(key, []).append(i)
            self._index = idx
        return self._index

    # -- ingestion ----------------------------------------------------------

    def _coerce(self, rows, values):
        rows = np.atleast_2d(np.asarray(rows, np.int32))
        if self.with_values:
            values = (np.zeros(rows.shape[0], np.float32) if values is None
                      else np.asarray(values, np.float32))
        else:
            values = None
        return rows, values

    def _append(self, rows: np.ndarray, values) -> np.ndarray:
        lo = self.count
        self.rows = np.concatenate([self.rows[:lo], rows])
        if self.with_values:
            base = (self.values[:lo] if self.values is not None
                    else np.zeros((0,), np.float32))
            self.values = np.concatenate([base, values])
        self.count = lo + rows.shape[0]
        self.alive = np.concatenate(
            [self.alive[:lo], np.ones(rows.shape[0], bool)])
        return np.arange(lo, self.count)

    def add(self, rows, values=None) -> None:
        """Ingest a chunk.  Unvalued stores append (duplicate rows are
        idempotent under the mining algebra); valued stores route
        through :meth:`upsert` — V must be a function of the tuple
        (§3.2), so a duplicate arrival *replaces* its predecessor, the
        same last-write-wins rule the batch constructor applies."""
        rows, values = self._coerce(rows, values)
        if rows.shape[0] == 0:
            return
        if self.with_values:
            self._upsert_coerced(rows, values)
            return
        new = self._append(rows, None)
        if self._index is not None:
            for key, i in zip(self._identity(rows), new.tolist()):
                self._index.setdefault(key, []).append(i)
        self.absorb()

    def upsert(self, rows, values=None) -> None:
        """Insert-or-replace: every alive prior version of each row's
        *tuple* (value ignored) is tombstoned, then the new version is
        appended — last write wins, exactly the constructor's
        canonicalisation."""
        rows, values = self._coerce(rows, values)
        if rows.shape[0] == 0:
            return
        self._upsert_coerced(rows, values)

    def _upsert_coerced(self, rows, values) -> None:
        index = self._ensure_index()
        new = self._append(rows, values)
        killed = 0
        for key, i in zip(self._identity(rows), new.tolist()):
            prior = index.get(key)
            if prior:
                for p in prior:
                    self.alive[p] = False
                killed += len(prior)
            index[key] = [i]
        self.dead += killed
        self._bump("tombstoned_rows", killed)
        self.absorb()

    def delete(self, rows) -> None:
        """Tombstone every alive version of the given tuples (rows never
        ingested are ignored).  Values are irrelevant to deletion."""
        rows = np.atleast_2d(np.asarray(rows, np.int32))
        if rows.shape[0] == 0:
            return
        index = self._ensure_index()
        killed = 0
        for key in self._identity(rows):
            prior = index.pop(key, None)
            if prior:
                for p in prior:
                    self.alive[p] = False
                killed += len(prior)
        self.dead += killed
        self._bump("tombstoned_rows", killed)

    # -- run maintenance ----------------------------------------------------

    def absorb(self) -> None:
        """Sort any rows not yet covered by runs (normally just the new
        chunk; the whole log after a lazy restore) into a fresh run,
        then compact geometrically-sized runs by linear merges.  Rows
        already tombstoned never enter the run."""
        lo, hi = self.covered, self.count
        if lo >= hi:
            return
        self.covered = hi
        if not self.incremental:
            return
        self._bump("chunk_sorted_rows", hi - lo)
        sel = (np.arange(lo, hi, dtype=np.int64)
               if self.alive[lo:hi].all()
               else np.nonzero(self.alive[lo:hi])[0] + lo)
        if sel.size == 0:
            return
        rows = self.rows[sel]
        vals = self.values[sel] if self.with_values else None
        keys, idx = [], []
        for plan in self.plans:
            k = plan.pack_host(rows, vals)
            order = (RX.radix_argsort_host(k, plan.total_bits)
                     if self.radix else np.argsort(k, kind="stable"))
            keys.append(k[order])
            idx.append(sel[order].astype(np.int32))
        self.runs.append(Run(keys, idx))
        while (len(self.runs) >= 2
               and self.runs[-2].size <= 2 * self.runs[-1].size):
            merged = merge_runs(self._filtered(self.runs[-2]),
                                self._filtered(self.runs[-1]))
            self._bump("merged_rows", merged.size)
            self.runs[-2:] = [merged]

    def _filtered(self, run: Run) -> Run:
        """The run without tombstoned entries (merges drop superseded
        versions — the LSM compaction rule)."""
        masks = [self.alive[i] for i in run.idx]
        if masks[0].all():
            return run
        return Run([k[m] for k, m in zip(run.keys, masks)],
                   [i[m] for i, m in zip(run.idx, masks)])

    def compact(self) -> None:
        """Rewrite the log to the survivor set (first-ingestion order of
        the surviving versions) and remap every run's indices.  Keys are
        untouched — survivor order is preserved — so no re-sort."""
        self.absorb()
        if not self.dead:
            return
        keep = self.alive[:self.count]
        remap = (np.cumsum(keep) - 1).astype(np.int32)
        self._bump("compacted_rows", self.count - int(keep.sum()))
        self.runs = [Run(r.keys, [remap[i] for i in r.idx])
                     for r in map(self._filtered, self.runs)]
        self.covered = int(remap[self.covered - 1]) + 1 if self.covered \
            else 0
        self.rows = self.rows[:self.count][keep]
        if self.with_values:
            self.values = self.values[:self.count][keep]
        self.count = int(keep.sum())
        self.alive = np.ones(self.count, bool)
        self.dead = 0
        self._index = None

    def prepare(self) -> None:
        """Make the store snapshot-ready: absorb the tail, drop every
        superseded version, compact the log, and fold all runs into one
        full per-mode permutation of the survivor table (linear merges —
        no re-sort)."""
        self.compact()
        if not self.incremental:
            return
        while len(self.runs) > 1:
            merged = merge_runs(self.runs[-2], self.runs[-1])
            self._bump("merged_rows", merged.size)
            self.runs[-2:] = [merged]

    # -- snapshot surface ---------------------------------------------------

    def table(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(rows, values) of the current log (call after
        :meth:`prepare`/:meth:`compact` for the survivor set)."""
        return (self.rows[:self.count],
                self.values[:self.count] if self.with_values else None)

    def perms(self, cap: Optional[int] = None) -> Optional[np.ndarray]:
        """(N, cap) merged per-mode permutations of the prepared store
        (``cap=None``: exactly ``count``), or None for non-incremental
        stores (the caller re-sorts on device)."""
        if not self.incremental:
            return None
        if len(self.runs) != 1 or self.dead or self.covered != self.count:
            raise ValueError("store not prepared; call prepare() first")
        cap = self.count if cap is None else int(cap)
        row0, val0 = self.rows[:1], (self.values[:1] if self.with_values
                                     else None)
        return padded_perms(self.runs[0], self.plans, row0, val0,
                            self.count, cap)

    # -- checkpoint ---------------------------------------------------------

    def checkpoint(self) -> dict:
        """Serialisable state *including* the run arrays, so restore is
        O(T) array loads — no re-sort.  The log is compacted first, so
        the blob carries exactly the survivor set (tombstones never
        outlive a checkpoint, and stripping a blob down to its buffer —
        the legacy format — cannot resurrect deleted rows)."""
        self.compact()
        blob = {"buffer": self.rows[:self.count].copy(),
                "count": self.count,
                "covered": self.covered,
                "runs": [{"keys": [k.copy() for k in r.keys],
                          "idx": [i.copy() for i in r.idx]}
                         for r in self.runs],
                "incremental": self.incremental}
        if self.plans is not None:
            blob["sizes"] = tuple(self.plans[0].sizes)
            blob["with_values"] = self.with_values
        if self.with_values:
            blob["values"] = self.values[:self.count].copy()
        return blob

    @staticmethod
    def restore(blob: dict,
                plans: Optional[Sequence[K.ModeKeyPlan]] = None
                ) -> "RunStore":
        """Rebuild a store from :meth:`checkpoint` output.  New-format
        blobs restore their runs and tombstones directly; legacy
        buffer-only blobs take the lazy path (``covered=0``) — one full
        chunk sort on the next absorb.  ``plans`` may be omitted for
        new-format blobs (rebuilt from the recorded sizes); a restoring
        engine re-attaches its own plans either way."""
        if plans is None and "sizes" in blob:
            plans = K.plan_context_keys(blob["sizes"],
                                        with_values=blob.get("with_values",
                                                             blob.get("values")
                                                             is not None))
        store = RunStore(plans, incremental=blob.get("incremental", True))
        rows = np.asarray(blob["buffer"], np.int32)
        store.rows = rows
        store.count = int(blob["count"])
        if blob.get("values") is not None:
            store.values = np.asarray(blob["values"], np.float32)
        store.alive = (np.asarray(blob["alive"], bool).copy()
                       if blob.get("alive") is not None
                       else np.ones(store.count, bool))
        store.dead = int(store.count - store.alive[:store.count].sum())
        if blob.get("runs"):
            store.runs = [Run([np.asarray(k, np.uint64) for k in r["keys"]],
                              [np.asarray(i, np.int32) for i in r["idx"]])
                          for r in blob["runs"]]
            store.covered = int(blob.get("covered", 0))
        else:
            store.runs, store.covered = [], 0   # lazy rebuild on absorb
        return store


# -- durable checkpoints (crash recovery) -----------------------------------

#: checkpoint frame: magic + ``<QI`` (payload length, CRC32 of payload),
#: followed by the ``.npz`` payload.  Files without the magic are
#: legacy plain-npz checkpoints and load without verification.
CKPT_MAGIC = b"RCK1"
_CKPT_HDR = struct.Struct("<QI")


class CheckpointCorruptError(RuntimeError):
    """A framed checkpoint failed its length/CRC check: the bytes on
    disk are not the bytes that were persisted.  Callers quarantine the
    file and fall back to the previous generation."""


def save_checkpoint(blob: dict, path: str, meta: Optional[dict] = None
                    ) -> None:
    """Persist a :meth:`RunStore.checkpoint` blob to ``path`` as a
    CRC32-framed ``.npz`` (nested run arrays flattened to named
    entries), written atomically — ``path.tmp`` then ``os.replace`` —
    so a crash mid-write can never leave a half-checkpoint where a
    restart would read it; the :data:`CKPT_MAGIC` header carries the
    payload length and checksum so :func:`load_checkpoint` can tell
    bit rot or truncation from a valid blob.  ``meta`` rides along
    (JSON-encoded) for engine-level counters the blob itself does not
    carry (e.g. the serving plane's ``stream_version`` / publish
    version)."""
    import io as _io
    import json as _json
    import os as _os
    import zlib as _zlib
    arrays = {"buffer": np.asarray(blob["buffer"], np.int32),
              "scalars": np.asarray(
                  [int(blob["count"]), int(blob.get("covered", 0)),
                   int(bool(blob.get("incremental", True))),
                   len(blob.get("runs") or ()),
                   int(bool(blob.get("with_values", False)))], np.int64)}
    if blob.get("values") is not None:
        arrays["values"] = np.asarray(blob["values"], np.float32)
    if blob.get("alive") is not None:
        arrays["alive"] = np.asarray(blob["alive"], bool)
    if "sizes" in blob:
        arrays["sizes"] = np.asarray(blob["sizes"], np.int64)
    for ri, r in enumerate(blob.get("runs") or ()):
        for m, (k, i) in enumerate(zip(r["keys"], r["idx"])):
            arrays[f"run{ri}_keys{m}"] = np.asarray(k, np.uint64)
            arrays[f"run{ri}_idx{m}"] = np.asarray(i, np.int32)
    arrays["meta_json"] = np.frombuffer(
        _json.dumps(meta or {}).encode(), np.uint8)
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(CKPT_MAGIC)
        f.write(_CKPT_HDR.pack(len(payload), _zlib.crc32(payload)))
        f.write(payload)
        f.flush()
        _os.fsync(f.fileno())
    _os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[dict, dict]:
    """Inverse of :func:`save_checkpoint`: returns ``(blob, meta)``
    ready for :meth:`RunStore.restore`.  Framed checkpoints are
    verified against their recorded length and CRC32 first — a
    truncated or bit-rotted file raises
    :class:`CheckpointCorruptError` instead of restoring garbage."""
    import io as _io
    import json as _json
    import zlib as _zlib
    with open(path, "rb") as f:
        head = f.read(len(CKPT_MAGIC))
        if head == CKPT_MAGIC:
            hdr = f.read(_CKPT_HDR.size)
            if len(hdr) < _CKPT_HDR.size:
                raise CheckpointCorruptError(
                    f"{path}: truncated frame header")
            length, crc = _CKPT_HDR.unpack(hdr)
            payload = f.read(length + 1)  # +1 detects trailing bytes
            if len(payload) != length:
                raise CheckpointCorruptError(
                    f"{path}: payload is {len(payload)} bytes, "
                    f"frame promised {length}")
            if _zlib.crc32(payload) != crc:
                raise CheckpointCorruptError(
                    f"{path}: payload CRC mismatch")
            src = _io.BytesIO(payload)
        else:
            src = path      # legacy plain .npz: no frame to verify
    with np.load(src) as z:
        count, covered, incremental, n_runs, with_values = (
            int(v) for v in z["scalars"])
        blob = {"buffer": z["buffer"], "count": count, "covered": covered,
                "incremental": bool(incremental),
                "with_values": bool(with_values)}
        if "values" in z.files:
            blob["values"] = z["values"]
        if "alive" in z.files:
            blob["alive"] = z["alive"]
        if "sizes" in z.files:
            blob["sizes"] = tuple(int(s) for s in z["sizes"])
        runs = []
        for ri in range(n_runs):
            keys, idx = [], []
            m = 0
            while f"run{ri}_keys{m}" in z.files:
                keys.append(z[f"run{ri}_keys{m}"])
                idx.append(z[f"run{ri}_idx{m}"])
                m += 1
            runs.append({"keys": keys, "idx": idx})
        blob["runs"] = runs
        meta = _json.loads(bytes(z["meta_json"].tobytes()).decode()
                           or "{}")
    return blob, meta
