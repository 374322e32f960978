"""Cluster-query serving surface: mined clusters as a queryable index
(DESIGN.md §8).  Port of ``repro.serve.clusters``.

``postprocess`` ranks and exports clusters; this module makes them
*servable*: a :class:`ClusterIndex` built once from any engine's
``PipelineResult`` answers point lookups —

* ``entity → clusters``: every kept cluster whose mode-``mode``
  component (any mode when unspecified) contains the entity,
* ``signature → cluster``: exact lookup by the 2×32-bit cluster
  signature, the stable cross-engine cluster identity (all engines with
  the same seed emit bit-identical signatures, so a signature handed
  out by a batch job resolves against a streaming snapshot's index).

Index construction is *vectorised* (the serving layer rebuilds it on
every snapshot swap, so it sits on the swap's critical path): the kept
tuples' component windows are stacked with one repeat/cumsum gather per
mode, deduplicated as packed ``(cluster << 32) | entity`` words with a
single ``np.unique``, and re-sorted once into per-mode
``(entity << 32) | cluster`` membership arrays (``mode_pairs``).
Entity queries are then two ``searchsorted`` probes; the ranking layer
(``serve.ranking``) reuses the same arrays for its batched path.
``cluster_query`` is the one-shot convenience wrapper; long-lived
serving should build the index once per snapshot
(``serve.service.TriclusterService`` does).

**The readback.**  The index is host numpy, as in the JAX package (it
is the structure shared-memory replicas map).  A result of the port
holds tensors — on the card for in-core and incremental snapshots, on
the host for windowed ones — and its signature lanes are int32 bit
patterns (``core.bits``).  :func:`host_result` reads the ten leaves an
index needs back once (not ``cardinalities`` or ``perms``), viewing the
signature lanes as uint32 there, so every array below is the JAX
package's array, dtype for dtype; a CUDA leaf's copy is the swap's
synchronisation point.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

_LOW32 = np.uint64(0xFFFFFFFF)
_HIGH32 = np.uint64(0xFFFFFFFF00000000)
_U32 = np.uint64(32)

#: The leaves of a ``PipelineResult`` an index reads.
INDEX_LEAVES = ("keep", "is_unique", "density", "sig_lo", "sig_hi",
                "gen_count", "volume", "range_lo", "range_hi", "sorted_e")
_SIG_LEAVES = ("sig_lo", "sig_hi")


def leaf(result, name: str) -> np.ndarray:
    """One result leaf as a host array: a tensor (on any device) is
    copied back, an array passes through, and the signature lanes —
    int32 bit patterns in the port — are viewed as uint32 (no copy)."""
    x = getattr(result, name)
    if hasattr(x, "detach"):            # a tensor; torch is not imported
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if name in _SIG_LEAVES and x.dtype == np.int32:
        x = x.view(np.uint32)
    return x


@dataclasses.dataclass(frozen=True)
class HostResult:
    """The :data:`INDEX_LEAVES` of one result on the host — what every
    index build reads, read back once per swap."""
    keep: np.ndarray
    is_unique: np.ndarray
    density: np.ndarray
    sig_lo: np.ndarray
    sig_hi: np.ndarray
    gen_count: np.ndarray
    volume: np.ndarray
    range_lo: np.ndarray
    range_hi: np.ndarray
    sorted_e: np.ndarray

    @property
    def nbytes(self) -> int:
        return sum(getattr(self, n).nbytes for n in INDEX_LEAVES)


def host_result(result) -> HostResult:
    """Read the leaves an index needs back to the host, once (a
    :class:`HostResult` passes through).  Raises for a result without
    component windows."""
    if isinstance(result, HostResult):
        return result
    for field in ("range_lo", "range_hi", "sorted_e"):
        if not hasattr(result, field):
            raise ValueError(
                f"result has no '{field}' — component windows are "
                "needed to build a ClusterIndex (DistributedResult "
                "does not carry them; build the index from a "
                "batch/streaming PipelineResult of the same context "
                "and resolve signatures against it)")
    return HostResult(**{n: leaf(result, n) for n in INDEX_LEAVES})


class LazyComponents:
    """Tuple-like per-mode component sets of one cluster, materialised
    per mode on first access from the index's shared stacked membership
    arrays.  Serving-path queries (ranked hits: signature/score/stats)
    usually never touch the sets, and eagerly building them dominated
    snapshot-swap latency — tens of millions of set inserts per swap at
    benchmark scale."""
    __slots__ = ("_ents", "_bounds", "_row", "_sets")

    def __init__(self, ents, bounds, row: int):
        self._ents = ents        # per mode: int64 member array
        self._bounds = bounds    # per mode: (n_clusters+1,) offsets
        self._row = row
        self._sets = [None] * len(ents)

    def __len__(self) -> int:
        return len(self._sets)

    def __getitem__(self, k):
        if isinstance(k, slice):
            return tuple(self[i] for i in range(len(self._sets))[k])
        if k < 0:
            k += len(self._sets)
        s = self._sets[k]
        if s is None:
            b = self._bounds[k]
            s = frozenset(
                self._ents[k][b[self._row]:b[self._row + 1]].tolist())
            self._sets[k] = s
        return s

    def __iter__(self):
        return (self[k] for k in range(len(self._sets)))

    def __eq__(self, other):
        if not isinstance(other, (tuple, list, LazyComponents)):
            return NotImplemented
        return (len(self) == len(other)
                and all(a == b for a, b in zip(self, other)))

    def __hash__(self):
        return hash(tuple(self))

    def __repr__(self):
        return repr(tuple(self))


@dataclasses.dataclass(frozen=True)
class ClusterView:
    """One mined cluster, host-side: per-mode component sets + stats."""
    signature: Tuple[int, int]            # (sig_lo, sig_hi) cluster id
    components: Tuple[frozenset, ...]     # per-mode entity-id sets
                                          # (or an equivalent
                                          # LazyComponents)
    density: float
    gen_count: int
    volume: float

    @property
    def arity(self) -> int:
        return len(self.components)

    def contains(self, entity: int, mode: Optional[int] = None) -> bool:
        if mode is not None:
            return entity in self.components[mode]
        return any(entity in c for c in self.components)

    def format(self, names=None) -> str:
        # deferred: postprocess imports torch; replica readers never
        # need it
        from ..core import postprocess as PP
        return PP.format_cluster(self.components, names=names,
                                 density=self.density)


def pack_sig_words(sig_lo, sig_hi) -> np.ndarray:
    """(lo, hi) signature pairs → one ``(hi << 32) | lo`` uint64 word —
    Stage 3's packed sort key, reused as the cluster identity that
    row-orders every index (``serve.ranking.pack_signatures`` is the
    same packing, re-exported there for the query side)."""
    lo = np.asarray(sig_lo).astype(np.uint64) & _LOW32
    hi = np.asarray(sig_hi).astype(np.uint64) & _LOW32
    return (hi << _U32) | lo


def _merge_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Merge two sorted uint64 arrays with disjoint values — one
    ``searchsorted`` + one ``np.insert`` memcpy, no re-sort."""
    if not b.size:
        return a
    if not a.size:
        return b
    return np.insert(a, np.searchsorted(a, b), b)


def _window_ce(rlo_k, rhi_k, sorted_e_k, sel, cl_rows) -> np.ndarray:
    """Stack the component windows of result rows ``sel`` per mode:
    repeat/cumsum flat gather, dedup as ``(cluster_row << 32) | entity``
    words in ONE ``np.unique`` (``cl_rows[i]`` is the index row embedded
    for ``sel[i]``) — the per-cluster python loop this replaces
    dominated snapshot-swap latency at serving scale."""
    counts = (rhi_k[sel] - rlo_k[sel]).astype(np.int64)
    total = int(counts.sum())
    starts = np.cumsum(counts) - counts
    flat = (np.arange(total, dtype=np.int64)
            - np.repeat(starts, counts)
            + np.repeat(rlo_k[sel].astype(np.int64), counts))
    ent = sorted_e_k[flat].astype(np.uint64)
    return np.unique(
        (np.repeat(cl_rows.astype(np.uint64), counts) << _U32) | ent)


class ClusterIndex:
    """Inverted index over kept clusters of one mining result.

    ``mode_pairs`` — one sorted uint64 array per mode of packed
    ``(entity << 32) | cluster_row`` membership words — is the single
    structure behind entity lookups here and the batched top-k path in
    ``serve.ranking``.  Indexes built by :meth:`from_result` /
    :meth:`delta_from_result` / :meth:`from_arrays` additionally carry
    ``packed_sigs`` (sorted — cluster rows are *signature-ordered*),
    ``comp_ents`` and ``comp_bounds``, which makes them delta-
    maintainable (``supports_delta``) and shared-memory-publishable
    (``serve.shm``); an index built from a plain cluster list
    reconstructs ``mode_pairs`` but supports neither."""

    def __init__(self, clusters: Optional[List[ClusterView]] = None,
                 mode_pairs: Optional[Sequence[np.ndarray]] = None, *,
                 any_pairs: Optional[np.ndarray] = None,
                 comp_ents: Optional[Sequence[np.ndarray]] = None,
                 comp_bounds: Optional[Sequence[np.ndarray]] = None,
                 packed_sigs: Optional[np.ndarray] = None,
                 stats: Optional[Tuple] = None):
        if clusters is None:
            # vectorised path: per-row stats arrays, NO view objects —
            # ``clusters`` materialises lazily; eager construction of
            # tens of thousands of views per swap was the dominant term
            # of the delta rebuild (it is O(clusters), the splice is
            # O(changed))
            if stats is None or comp_ents is None:
                raise ValueError("array-built index needs stats= and "
                                 "comp_ents=")
            (self.sig_lo, self.sig_hi, self.density, self.gen_count,
             self.volume) = (np.asarray(a) for a in stats)
            self._clusters: Optional[List[ClusterView]] = None
            self._view_cache: dict = {}
            self._n = int(self.sig_lo.size)
            arity = len(comp_ents)
        else:
            self._clusters = list(clusters)
            self._n = len(self._clusters)
            arity = self._clusters[0].arity if self._clusters else 0
            self.sig_lo = np.fromiter(
                (c.signature[0] for c in self._clusters), np.int64,
                self._n)
            self.sig_hi = np.fromiter(
                (c.signature[1] for c in self._clusters), np.int64,
                self._n)
            self.density = np.fromiter(
                (c.density for c in self._clusters), np.float64, self._n)
            self.gen_count = np.fromiter(
                (c.gen_count for c in self._clusters), np.int64, self._n)
            self.volume = np.fromiter(
                (c.volume for c in self._clusters), np.float64, self._n)
        self._by_sig: Optional[dict] = None
        if mode_pairs is None:
            mode_pairs = []
            for k in range(arity):
                pairs = [(int(e) << 32) | row
                         for row, c in enumerate(self.clusters)
                         for e in c.components[k]]
                mode_pairs.append(np.sort(np.asarray(pairs, np.uint64)))
        self._mode_pairs: Optional[List[np.ndarray]] = list(mode_pairs)
        self._any_pairs: Optional[np.ndarray] = (
            any_pairs if any_pairs is not None
            else np.unique(np.concatenate(self._mode_pairs))
            if self._mode_pairs else np.zeros(0, np.uint64))
        # row-major stacked members (``LazyComponents`` backing) and the
        # sorted packed signature words — present iff built vectorised
        self._comp_ents = None if comp_ents is None else list(comp_ents)
        self._comp_bounds = (None if comp_bounds is None
                             else list(comp_bounds))
        self.packed_sigs = packed_sigs
        self._arity = len(self._mode_pairs)
        self._init_overlay_none()

    def _init_overlay_none(self) -> None:
        # overlay state (see delta_from_result): None/0 on flat indexes
        self._base: Optional["ClusterIndex"] = None
        self._lut: Optional[np.ndarray] = None          # id -> row, -1 dead
        self._id_of_row: Optional[np.ndarray] = None    # row -> stable id
        self._ov_words: Optional[List[np.ndarray]] = None
        self._ov_ents: Optional[List[np.ndarray]] = None
        self._ov_bounds: Optional[List[np.ndarray]] = None
        self._ov_any: Optional[np.ndarray] = None
        self._n_ov = 0
        self._dead_words = 0

    # -- flat stacked arrays -------------------------------------------------
    # On a delta-built (overlay) index these materialise lazily — and
    # cache — so the swap-critical delta build never pays for them; the
    # zero-copy publisher, the batched stacker and identity checks do,
    # once, on first demand.

    @property
    def arity(self) -> int:
        """Number of modes, without materialising anything."""
        return self._arity

    @property
    def mode_pairs(self) -> List[np.ndarray]:
        if self._mode_pairs is None:
            self._ensure_flat()
        return self._mode_pairs

    @property
    def any_pairs(self) -> np.ndarray:
        if self._any_pairs is None:
            self._ensure_flat()
        return self._any_pairs

    @property
    def comp_ents(self) -> Optional[List[np.ndarray]]:
        if self._comp_ents is None and self._base is not None:
            self._ensure_flat()
        return self._comp_ents

    @property
    def comp_bounds(self) -> Optional[List[np.ndarray]]:
        if self._comp_bounds is None and self._base is not None:
            self._ensure_flat()
        return self._comp_bounds

    @property
    def clusters(self) -> List[ClusterView]:
        """Per-row host views, built on first access (bulk ``.tolist``
        — cheaper than per-row numpy scalar indexing)."""
        if self._clusters is None:
            slo_l, shi_l = self.sig_lo.tolist(), self.sig_hi.tolist()
            dens_l = self.density.tolist()
            gen_l, vol_l = self.gen_count.tolist(), self.volume.tolist()
            cache = self._view_cache
            # reuse any per-row views already handed out: callers may
            # hold them and rely on identity with later lookups
            self._clusters = [cache.get(i) or ClusterView(
                signature=(slo_l[i], shi_l[i]),
                components=LazyComponents(*self._comp_source(i)),
                density=dens_l[i], gen_count=gen_l[i], volume=vol_l[i])
                for i in range(self._n)]
        return self._clusters

    def _comp_source(self, row: int):
        """(ents, bounds, index) triple backing ``row``'s per-mode
        component slices — the base arrays for carried-over clusters,
        the overlay for clusters first seen after the base snapshot;
        never materialises the flat arrays."""
        if self._base is None or self._comp_ents is not None:
            return self._comp_ents, self._comp_bounds, row
        i = int(self._id_of_row[row])
        nb = len(self._base)
        if i < nb:
            return self._base._comp_ents, self._base._comp_bounds, i
        return self._ov_ents, self._ov_bounds, i - nb

    def view_at(self, row: int) -> ClusterView:
        """One row's view without materialising the whole list — the
        ranked-hit path touches k rows of tens of thousands.  Views are
        memoised per row, so repeated hits share one object."""
        if self._clusters is not None:
            return self._clusters[row]
        row = int(row)
        v = self._view_cache.get(row)
        if v is None:
            # setdefault: concurrent readers racing on the same row
            # still end up sharing one canonical view object
            v = self._view_cache.setdefault(row, ClusterView(
                signature=(int(self.sig_lo[row]), int(self.sig_hi[row])),
                components=LazyComponents(*self._comp_source(row)),
                density=float(self.density[row]),
                gen_count=int(self.gen_count[row]),
                volume=float(self.volume[row])))
        return v

    def signature_keys(self) -> List[Tuple[int, int]]:
        """Row-aligned ``(sig_lo, sig_hi)`` tuples without building
        views (the recency/first-seen bookkeeping key)."""
        return list(zip(self.sig_lo.tolist(), self.sig_hi.tolist()))

    @property
    def supports_delta(self) -> bool:
        """True when this index carries the signature-sorted stacked
        arrays (or an overlay over them) that
        :meth:`delta_from_result` extends; never materialises."""
        return (self.packed_sigs is not None
                and (self._comp_ents is not None
                     or self._base is not None))

    @staticmethod
    def _kept_rows(result: HostResult, only_kept: bool,
                   min_density: float):
        """Select kept result rows and order them by packed signature —
        the row order of every vectorised index.  Signature order (not
        keep order) is what makes delta maintenance O(changed): the
        survivor old→new row remap is then monotone, so masked old
        arrays stay sorted after remapping."""
        flag = result.keep if only_kept else result.is_unique
        dens = result.density
        if min_density:
            flag = flag & (dens >= min_density)
        sel = np.nonzero(flag)[0]
        slo = result.sig_lo
        shi = result.sig_hi
        sw = pack_sig_words(slo[sel], shi[sel])
        order = np.argsort(sw, kind="stable")
        return sel[order], sw[order], slo, shi, dens

    @staticmethod
    def _stats_for(result: HostResult, sel, slo, shi, dens) -> Tuple:
        """Row-aligned per-cluster stats arrays (no view objects — the
        views materialise lazily from exactly these arrays)."""
        return (slo[sel], shi[sel], dens[sel], result.gen_count[sel],
                result.volume[sel])

    @classmethod
    def from_result(cls, result, only_kept: bool = True,
                    min_density: float = 0.0) -> "ClusterIndex":
        """Build from a ``PipelineResult`` (batch / NOAC / streaming —
        any result carrying component windows).  ``DistributedResult``
        ships per-shard aggregates without the windows; serve those by
        mining the snapshot through the streaming/batch engine (or
        ``DistributedMiner.serving_snapshot``), or resolve its
        signatures against an index built from one (the signatures are
        bit-identical across engines).

        This is the full rebuild — the *oracle* the delta path
        (:meth:`delta_from_result`) must reproduce bit-identically.
        ``result`` may be a :class:`HostResult` already read back."""
        result = host_result(result)
        sel, packed, slo, shi, dens = cls._kept_rows(
            result, only_kept, min_density)
        rlo, rhi = result.range_lo, result.range_hi
        sorted_e = result.sorted_e
        n_modes = sorted_e.shape[0]
        nk = int(sel.size)
        comp_ents, comp_bounds, mode_pairs = [], [], []
        cl_rows = np.arange(nk, dtype=np.uint64)
        for k in range(n_modes):
            ce = _window_ce(rlo[k], rhi[k], sorted_e[k], sel, cl_rows)
            comp_ents.append((ce & _LOW32).astype(np.int64))
            comp_bounds.append(np.searchsorted(ce >> _U32,
                                               np.arange(nk + 1)))
            mode_pairs.append(np.sort((ce << _U32) | (ce >> _U32)))
        return cls(mode_pairs=mode_pairs, comp_ents=comp_ents,
                   comp_bounds=comp_bounds, packed_sigs=packed,
                   stats=cls._stats_for(result, sel, slo, shi, dens))

    @classmethod
    def delta_from_result(cls, prev: "ClusterIndex", result,
                          only_kept: bool = True,
                          min_density: float = 0.0) -> "ClusterIndex":
        """Build the index for ``result`` in O(changed clusters) by
        layering an *overlay* over ``prev``'s stacked arrays instead of
        restacking every membership word.

        Clusters are diffed by packed Stage-3 signature — the invariant
        this relies on is exactly the cross-engine identity contract:
        *signature-equal ⇒ membership-equal* (the signature is an
        order-independent hash of the component sets).  Survivors keep
        their *stable id* (their row in the base snapshot); the base
        membership arrays are never rewritten.  The delta build only

        * restacks the *dirty* clusters' windows into a small sorted
          overlay of ``(entity << 32) | id`` words,
        * rebuilds the O(n_clusters) id→row lut (``-1`` tombstones
          deleted clusters) and the per-row stats arrays.

        Queries answer from base + overlay directly (two probes, lut
        remap on the hit slice only), so the swap-critical path never
        touches the O(M) word arrays.  The canonical flat arrays — what
        ``from_result`` builds, and what the zero-copy publisher and
        the batched stacker consume — materialise lazily on first
        demand and are then cached, which also promotes this index to a
        base for the next delta.  Per-cluster stats (density /
        gen_count / volume *can* change for an unchanged signature) are
        re-read from ``result`` for every row, so the materialised
        output is bit-identical to ``from_result(result)``.

        Falls back to a full build when ``prev`` lacks the stacked
        arrays, or when the overlay / tombstoned portion outgrows the
        base (self-compaction keeps query probes cheap).
        """
        result = host_result(result)
        if not prev.supports_delta:
            return cls.from_result(result, only_kept=only_kept,
                                   min_density=min_density)
        sel, packed, slo, shi, dens = cls._kept_rows(
            result, only_kept, min_density)
        nk = int(sel.size)
        old = prev.packed_sigs
        n_old = int(old.size)
        # survivor matching: both signature lists sorted, one pass
        if n_old:
            pos = np.searchsorted(old, packed)
            posc = np.minimum(pos, n_old - 1)
            sur = old[posc] == packed
        else:
            pos = np.zeros(nk, np.int64)
            sur = np.zeros(nk, bool)
        new_sur = np.nonzero(sur)[0]
        old_sur = pos[sur]
        sur_mask_old = np.zeros(n_old, bool)
        sur_mask_old[old_sur] = True
        deleted_old = np.nonzero(~sur_mask_old)[0]
        dirty_rows = np.nonzero(~sur)[0]
        sel_dirty = sel[~sur]
        # a prev with materialised flat arrays is itself the next base
        # (chain depth stays 1); an un-materialised overlay prev shares
        # its base and extends its overlay
        if prev._comp_ents is not None:
            base, prev_ids, n_ov0, dead = prev, None, 0, 0
            ov_w0 = [np.zeros(0, np.uint64)] * prev._arity
            ov_e0 = [np.zeros(0, np.int64)] * prev._arity
            ov_b0 = [np.zeros(1, np.int64)] * prev._arity
            ov_a0 = np.zeros(0, np.uint64)
        else:
            base, prev_ids = prev._base, prev._id_of_row
            n_ov0, dead = prev._n_ov, prev._dead_words
            ov_w0, ov_e0 = prev._ov_words, prev._ov_ents
            ov_b0, ov_a0 = prev._ov_bounds, prev._ov_any
        nb = len(base)
        arity = base._arity
        rlo, rhi = result.range_lo, result.range_hi
        # self-compaction: once the overlay plus the dead (tombstoned)
        # words outgrow the base, rebuild flat — the full build is the
        # oracle, so compaction is just from_result
        del_ids = (deleted_old if prev_ids is None
                   else prev_ids[deleted_old])
        dirty_est = 0
        for k in range(arity):
            bb, ob = base._comp_bounds[k], ov_b0[k]
            bi = del_ids[del_ids < nb]
            oi = del_ids[del_ids >= nb] - nb
            dead += int((bb[bi + 1] - bb[bi]).sum())
            dead += int((ob[oi + 1] - ob[oi]).sum())
            dirty_est += int((rhi[k][sel_dirty] - rlo[k][sel_dirty]).sum())
        base_words = (sum(int(mp.size) for mp in base._mode_pairs)
                      + int(base._any_pairs.size))
        ov_words_est = sum(int(w.size) for w in ov_w0) + 2 * dirty_est
        if nb == 0 or 2 * (ov_words_est + dead) > base_words:
            return cls.from_result(result, only_kept=only_kept,
                                   min_density=min_density)
        # stable ids: survivors inherit, dirty clusters get fresh ids
        # appended after the base + existing overlay
        n_dirty = int(dirty_rows.size)
        id_of_row = np.empty(nk, np.int64)
        id_of_row[new_sur] = (old_sur if prev_ids is None
                              else prev_ids[old_sur])
        new_ids = nb + n_ov0 + np.arange(n_dirty, dtype=np.int64)
        id_of_row[dirty_rows] = new_ids
        lut = np.full(nb + n_ov0 + n_dirty, -1, np.int64)
        lut[id_of_row] = np.arange(nk, dtype=np.int64)
        # restack ONLY the dirty clusters' windows, keyed by stable id
        sorted_e = result.sorted_e
        gid_bounds = np.arange(nb + n_ov0, nb + n_ov0 + n_dirty + 1)
        ov_words, ov_ents, ov_bounds, dirty_any = [], [], [], []
        for k in range(arity):
            ce_d = _window_ce(rlo[k], rhi[k], sorted_e[k], sel_dirty,
                              new_ids.astype(np.uint64))
            w_d = np.sort((ce_d << _U32) | (ce_d >> _U32))
            dirty_any.append(w_d)
            ov_words.append(_merge_sorted(ov_w0[k], w_d))
            ov_ents.append(np.concatenate(
                (ov_e0[k], (ce_d & _LOW32).astype(np.int64))))
            db = np.searchsorted(ce_d >> _U32, gid_bounds)
            ov_bounds.append(np.concatenate(
                (ov_b0[k], ov_b0[k][-1] + db[1:])))
        a_d = (np.unique(np.concatenate(dirty_any)) if dirty_any
               else np.zeros(0, np.uint64))
        ov_any = _merge_sorted(ov_a0, a_d)
        return cls._make_overlay(
            base=base, lut=lut, id_of_row=id_of_row, ov_words=ov_words,
            ov_ents=ov_ents, ov_bounds=ov_bounds, ov_any=ov_any,
            n_ov=n_ov0 + n_dirty, dead_words=dead, packed_sigs=packed,
            stats=cls._stats_for(result, sel, slo, shi, dens))

    @classmethod
    def _make_overlay(cls, *, base, lut, id_of_row, ov_words, ov_ents,
                      ov_bounds, ov_any, n_ov, dead_words, packed_sigs,
                      stats) -> "ClusterIndex":
        self = object.__new__(cls)
        (self.sig_lo, self.sig_hi, self.density, self.gen_count,
         self.volume) = (np.asarray(a) for a in stats)
        self._clusters = None
        self._view_cache = {}
        self._n = int(self.sig_lo.size)
        self._by_sig = None
        self._mode_pairs = None
        self._any_pairs = None
        self._comp_ents = None
        self._comp_bounds = None
        self.packed_sigs = packed_sigs
        self._arity = base._arity
        self._base = base
        self._lut = lut
        self._id_of_row = id_of_row
        self._ov_words = ov_words
        self._ov_ents = ov_ents
        self._ov_bounds = ov_bounds
        self._ov_any = ov_any
        self._n_ov = int(n_ov)
        self._dead_words = int(dead_words)
        return self

    def _ensure_flat(self) -> None:
        """Materialise (and cache) the canonical flat arrays of an
        overlay-backed index — bit-identical to what ``from_result``
        builds for the same snapshot.  Off the swap-critical path: runs
        on first demand from the zero-copy publisher, the batched
        stacker, or an identity check; afterwards this index serves as
        a base for subsequent deltas."""
        if self._mode_pairs is not None:
            return
        base, nk = self._base, self._n
        nb = len(base)
        lut_b = self._lut[:nb]
        alive_b = lut_b >= 0
        have_dead = not bool(alive_b.all())
        # sentinel splice: an O(n) L2-resident table re-stamps the low
        # 32-bit id field to the current row with one gather + add (the
        # shift never borrows into the entity field; uint64 wraparound
        # realises negative shifts).  Tombstoned ids carry bit 63 — a
        # live word never does while entity ids stay below 2^31 — so
        # one compare + compress drops deleted clusters' words.
        _SENT = np.uint64(1) << np.uint64(63)
        tab = (lut_b - np.arange(nb, dtype=np.int64)).astype(np.uint64)
        tab[~alive_b] = _SENT
        plain = bool(
            all(not mp.size or mp[-1] < _SENT
                for mp in base._mode_pairs)
            and (not base._any_pairs.size
                 or base._any_pairs[-1] < _SENT))
        lut = self._lut

        def splice(words: np.ndarray, ov: np.ndarray) -> np.ndarray:
            if words.size:
                if plain:
                    v = words + tab[words & _LOW32]
                    v = v[v < _SENT] if have_dead else v
                else:
                    # entity ids >= 2^31 collide with the sentinel:
                    # fall back to an explicit keep gather
                    ids = (words & _LOW32).astype(np.int64)
                    v = words + (tab[ids] & ~_SENT)
                    v = v[alive_b[ids]] if have_dead else v
            else:
                v = words
            if ov.size:
                rows_o = lut[(ov & _LOW32).astype(np.int64)]
                ok = rows_o >= 0
                w_o = np.sort((ov[ok] & _HIGH32)
                              | rows_o[ok].astype(np.uint64))
                v = _merge_sorted(v, w_o)
            return v

        mode_pairs = [splice(base._mode_pairs[k], self._ov_words[k])
                      for k in range(self._arity)]
        any_pairs = splice(base._any_pairs, self._ov_any)
        # row-major members: base survivors keep contiguous slices in
        # row order (the id→row remap is monotone on the base — both
        # orders are signature order); alive overlay clusters' slices
        # are inserted at their row's offset
        rows_ov = lut[nb:]
        alive_o = np.nonzero(rows_ov >= 0)[0]
        ord_o = alive_o[np.argsort(rows_ov[alive_o], kind="stable")]
        comp_ents, comp_bounds = [], []
        for k in range(self._arity):
            pe, pb = base._comp_ents[k], base._comp_bounds[k]
            oc = np.diff(pb)
            pe_sur = pe[np.repeat(alive_b, oc)] if have_dead else pe
            ob = self._ov_bounds[k]
            ocnt = ob[1:] - ob[:-1]
            counts = np.zeros(nk, np.int64)
            counts[lut_b[alive_b]] = oc[alive_b]
            counts[rows_ov[alive_o]] = ocnt[alive_o]
            comp_bounds.append(np.concatenate(
                (np.zeros(1, np.int64),
                 np.cumsum(counts, dtype=np.int64))))
            if ord_o.size:
                oe = self._ov_ents[k]
                ents_o = np.concatenate(
                    [oe[ob[i]:ob[i + 1]] for i in ord_o.tolist()])
                counts_sur = counts.copy()
                counts_sur[rows_ov[alive_o]] = 0
                sur_prefix = np.concatenate(
                    (np.zeros(1, np.int64),
                     np.cumsum(counts_sur, dtype=np.int64)))
                obj = np.repeat(sur_prefix[rows_ov[ord_o]],
                                ocnt[ord_o])
                comp_ents.append(np.insert(pe_sur, obj, ents_o))
            else:
                comp_ents.append(pe_sur)
        self._mode_pairs = mode_pairs
        self._any_pairs = any_pairs
        self._comp_ents = comp_ents
        self._comp_bounds = comp_bounds

    @classmethod
    def from_arrays(cls, packed_sigs, mode_pairs, comp_ents, comp_bounds,
                    any_pairs, density, gen_count,
                    volume) -> "ClusterIndex":
        """Reassemble an index from its published stacked arrays — the
        replica-reader path (``serve.shm``): the arrays arrive as
        zero-copy shared-memory views and are *not* copied here; only
        the per-row host views are rebuilt."""
        sigs_lo = (np.asarray(packed_sigs) & _LOW32).astype(np.int64)
        sigs_hi = (np.asarray(packed_sigs) >> _U32).astype(np.int64)
        return cls(mode_pairs=list(mode_pairs),
                   any_pairs=any_pairs, comp_ents=list(comp_ents),
                   comp_bounds=list(comp_bounds), packed_sigs=packed_sigs,
                   stats=(sigs_lo, sigs_hi, np.asarray(density),
                          np.asarray(gen_count), np.asarray(volume)))

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[ClusterView]:
        return iter(self.clusters)

    def _lookup_sig(self, sig: Tuple[int, int]) -> Optional[ClusterView]:
        """Exact-signature row: one searchsorted probe into the sorted
        packed words when available, else a lazily-built dict."""
        if self.packed_sigs is not None:
            w = pack_sig_words(sig[0], sig[1])
            i = int(np.searchsorted(self.packed_sigs, w))
            if i < self._n and self.packed_sigs[i] == w:
                return self.view_at(i)
            return None
        if self._by_sig is None:
            self._by_sig = {c.signature: c for c in self.clusters}
        return self._by_sig.get((int(sig[0]), int(sig[1])))

    def entity_rows(self, entity: int,
                    mode: Optional[int] = None) -> np.ndarray:
        """Cluster rows whose mode-``mode`` (any-mode when None)
        component contains ``entity``, ascending — two ``searchsorted``
        probes into the packed membership words."""
        e = int(entity)
        if e < 0 or e >= 1 << 32:
            return np.zeros(0, np.int64)

        def window(pairs: np.ndarray) -> np.ndarray:
            lo = np.searchsorted(pairs, np.uint64(e << 32))
            hi = (pairs.size if e + 1 >= 1 << 32  # avoid uint64 overflow
                  else np.searchsorted(pairs, np.uint64((e + 1) << 32)))
            return pairs[lo:hi]

        if self._base is None or self._mode_pairs is not None:
            pairs = (self.any_pairs if mode is None
                     else self.mode_pairs[mode])
            return (window(pairs) & _LOW32).astype(np.int64)
        # overlay path: probe base + overlay words (both keyed by stable
        # id), remap the hit slices through the lut, drop tombstones
        base = self._base
        b = (base._any_pairs if mode is None else base._mode_pairs[mode])
        o = self._ov_any if mode is None else self._ov_words[mode]
        ids = np.concatenate(((window(b) & _LOW32).astype(np.int64),
                              (window(o) & _LOW32).astype(np.int64)))
        rows = self._lut[ids]
        return np.sort(rows[rows >= 0])

    def query(self, entity: Optional[int] = None,
              mode: Optional[int] = None,
              signature: Optional[Tuple[int, int]] = None,
              min_density: float = 0.0) -> List[ClusterView]:
        """Kept clusters matching the given constraints.

        ``signature=(lo, hi)``: exact cluster lookup (≤ 1 hit).
        ``entity=e [, mode=k]``: membership in mode ``k``'s component
        (any mode when ``mode`` is None; ``mode`` without ``entity`` is
        rejected).  Constraints combine with AND.
        """
        if mode is not None:
            if entity is None:
                raise ValueError("mode=... requires entity=...")
            if self._n and not 0 <= mode < self._arity:
                raise ValueError(f"mode {mode} out of range")
            if not self._n:                 # empty index: no hits
                return []
        if signature is not None:
            hit = self._lookup_sig((int(signature[0]),
                                    int(signature[1])))
            out = [] if hit is None else [hit]
            if entity is not None:
                out = [c for c in out if c.contains(int(entity), mode)]
        elif entity is not None:
            out = [self.view_at(r)
                   for r in self.entity_rows(entity, mode)]
        else:
            out = list(self.clusters)
        if min_density:
            out = [c for c in out if c.density >= min_density]
        return out


def cluster_query(result, entity: Optional[int] = None,
                  mode: Optional[int] = None,
                  signature: Optional[Tuple[int, int]] = None,
                  min_density: float = 0.0,
                  only_kept: bool = True) -> List[ClusterView]:
    """One-shot query over a mining result: build the index and look up
    (``ClusterIndex.from_result(...).query(...)``).

    Hits come back *ranked* — best density first (ties keep index
    order), matching the serving layer's default policy — not in
    whatever order the index happened to store them."""
    hits = ClusterIndex.from_result(result, only_kept=only_kept).query(
        entity=entity, mode=mode, signature=signature,
        min_density=min_density)
    from .ranking import rank_views       # deferred: ranking imports us
    return [v for v, _ in rank_views([(c, c.density) for c in hits])]
