"""Ranking layer over the cluster-query surface (DESIGN.md §8).  Port of
``repro.serve.ranking``: the same numpy over the same host arrays
(``serve.clusters`` reads a result back once), so scores and orders are
the JAX package's, float for float.

``serve.clusters.ClusterIndex`` answers *membership*; this module
answers *which hits matter*: every cluster of a snapshot gets one scalar
score — a weighted sum of density, log-scaled volume and recency
(``RankingPolicy``) — and queries return hits best-first.

Two query paths share the same scores and the same ordering:

* scalar (``BatchQuerier.topk``): one per-entity probe through the
  index plus a per-query python sort — the serving baseline;
* batched (``BatchQuerier.topk_batch``): the per-mode component windows
  of the snapshot are *stacked* once at build time into a single sorted
  array of packed ``(entity << 32) | cluster_row`` words (the
  ``core.keys`` trick — one word comparison instead of a tuple compare),
  so a multi-entity query is two vectorised ``searchsorted`` passes plus
  one ``lexsort`` over the combined hit set, instead of N python probes
  and N python sorts.  Both paths return bit-identical hit lists
  (tested), so callers can batch opportunistically.

Cluster *signatures* rank the same way: ``pack_signatures`` folds the
2×32-bit cross-engine signature into one uint64 word (exactly Stage 3's
packed sort key), and ``BatchQuerier.lookup_signatures`` resolves a
batch of signatures — issued by *any* engine with the same seed —
against the snapshot in one ``searchsorted`` pass.

Recency is a property of the *stream*, not of one mining result: the
serving layer (``serve.service``) tracks, per signature, the snapshot
version that first published it, and passes per-cluster ages here.
Without ages every cluster counts as fresh.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .clusters import ClusterIndex, ClusterView


@dataclasses.dataclass(frozen=True)
class RankingPolicy:
    """Score = ``w_density * density + w_volume * vol + w_recency * rec``
    with ``vol = log1p(volume) / log1p(max volume in snapshot)`` (so one
    huge cluster cannot drown the density term) and
    ``rec = 1 / (1 + age_in_versions)`` (1.0 for clusters first seen in
    the current snapshot).  All three terms live in [0, 1]."""
    w_density: float = 1.0
    w_volume: float = 0.0
    w_recency: float = 0.0


DEFAULT_POLICY = RankingPolicy()


def cluster_scores(index: ClusterIndex,
                   policy: RankingPolicy = DEFAULT_POLICY,
                   ages: Optional[np.ndarray] = None) -> np.ndarray:
    """One float64 score per ``index.clusters`` row (ties are broken by
    row order everywhere downstream, so equal-score rankings are still
    deterministic)."""
    n = len(index)
    dens = index.density.astype(np.float64)
    score = policy.w_density * dens
    if policy.w_volume:
        vol = np.log1p(index.volume.astype(np.float64))
        score = score + policy.w_volume * (vol / max(vol.max(initial=0.0),
                                                     1e-12))
    if policy.w_recency:
        age = (np.zeros(n, np.float64) if ages is None
               else np.asarray(ages, np.float64))
        score = score + policy.w_recency / (1.0 + age)
    return score


def rank_views(hits: Sequence[Tuple[ClusterView, float]],
               k: Optional[int] = None) -> List[Tuple[ClusterView, float]]:
    """Best-first ordering of (view, score) pairs, stable in input order
    on ties; ``k`` truncates."""
    out = sorted(enumerate(hits), key=lambda t: (-t[1][1], t[0]))
    return [h for _, h in (out if k is None else out[:k])]


def top_clusters(index: ClusterIndex, k: int = 10,
                 policy: RankingPolicy = DEFAULT_POLICY,
                 ages: Optional[np.ndarray] = None
                 ) -> List[Tuple[ClusterView, float]]:
    """Global top-k of a snapshot (no entity constraint)."""
    scores = cluster_scores(index, policy, ages)
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return [(index.view_at(int(i)), float(scores[i])) for i in order]


def pack_signatures(sig_lo, sig_hi) -> np.ndarray:
    """(lo, hi) uint32 pairs → one uint64 word, ``(hi << 32) | lo`` —
    the same single-word form Stage 3 sorts (``core.keys``), reused here
    as the O(log n)-resolvable serving identity."""
    lo = np.asarray(sig_lo, np.uint64) & np.uint64(0xFFFFFFFF)
    hi = np.asarray(sig_hi, np.uint64) & np.uint64(0xFFFFFFFF)
    return (hi << np.uint64(32)) | lo


def top_from_scores(index: ClusterIndex, scores: np.ndarray, k: int = 10
                    ) -> List[Tuple[ClusterView, float]]:
    """Global top-k from an already-computed score vector (the replica
    path reuses the scores the writer published; identical ordering to
    :func:`top_clusters` given the same scores)."""
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return [(index.view_at(int(i)), float(scores[i])) for i in order]


class BatchQuerier:
    """Ranked lookups over one snapshot's :class:`ClusterIndex`.

    Built once per snapshot (O(total component membership) stacking +
    sorts); immutable afterwards, so it is shared freely across reader
    threads like the index itself."""

    def __init__(self, index: ClusterIndex,
                 policy: RankingPolicy = DEFAULT_POLICY,
                 ages: Optional[np.ndarray] = None,
                 scores: Optional[np.ndarray] = None):
        self.index = index
        self.policy = policy
        #: ``scores`` short-circuits the recompute — replica readers
        #: (serve.shm) rank with the exact score vector the writer
        #: published, so writer and replicas answer bit-identically
        self.scores = (np.asarray(scores, np.float64) if scores is not None
                       else cluster_scores(index, policy, ages))
        #: bits of the packed word holding the cluster row (low field) —
        #: the index's membership words are always (entity << 32) | row
        self.cluster_bits = 32
        self._row_mask = np.uint64(0xFFFFFFFF)
        # the stacked component windows are shared with the index, but
        # pulled lazily: a delta-built index answers scalar probes from
        # its overlay without ever materialising the flat arrays, so
        # constructing a querier stays off the swap-critical path
        self._keys_cache: Optional[Tuple[List[np.ndarray], np.ndarray]] \
            = None
        # signature resolution: sorted packed words + their rows; a
        # vectorised index is already row-ordered by packed signature,
        # so its sig array is reused as-is (argsort is the identity) —
        # and no view objects are touched anywhere in construction
        if index.packed_sigs is not None:
            self._sig_sorted = index.packed_sigs
            self._sig_order = np.arange(len(index), dtype=np.int64)
        else:
            sigs = pack_signatures(index.sig_lo, index.sig_hi)
            self._sig_order = np.argsort(sigs).astype(np.int64)
            self._sig_sorted = sigs[self._sig_order]

    # -- scalar path (the baseline) -----------------------------------------

    def topk(self, entity: int, mode: Optional[int] = None, k: int = 10
             ) -> List[Tuple[ClusterView, float]]:
        """Per-entity probe + per-query sort: best-``k`` clusters whose
        mode-``mode`` (any-mode when None) component holds ``entity``.
        Ordering: score desc, cluster row asc — identical to
        :meth:`topk_batch`."""
        if mode is not None:
            if not len(self.index):
                return []
            if not 0 <= mode < self.index.arity:
                raise ValueError(f"mode {mode} out of range")
        rows = self.index.entity_rows(int(entity), mode).tolist()
        order = sorted(rows, key=lambda r: (-self.scores[r], r))[:k]
        return [(self.index.view_at(r), float(self.scores[r]))
                for r in order]

    # -- batched path --------------------------------------------------------

    def _stacked(self, mode: Optional[int]) -> np.ndarray:
        if self._keys_cache is None:
            # first batched query materialises (and caches) the flat
            # stacked arrays — a no-op on a full-built index
            self._keys_cache = (self.index.mode_pairs,
                                self.index.any_pairs)
        mode_keys, any_keys = self._keys_cache
        if mode is None:
            return any_keys
        if not mode_keys:
            return np.zeros(0, np.uint64)
        if not 0 <= mode < len(mode_keys):
            raise ValueError(f"mode {mode} out of range")
        return mode_keys[mode]

    def topk_batch_raw(self, entities, mode: Optional[int] = None,
                       k: int = 10):
        """The vectorised core: (qid, cluster_row, score) int64/float64
        arrays, grouped by query, best-first within each query.  Two
        ``searchsorted`` passes bound every entity's slice of the stacked
        member array, one ``lexsort`` ranks the combined hit set, and the
        top-``k`` mask needs no per-query python at all."""
        keys = self._stacked(mode)
        qi = np.asarray(entities, np.int64)
        # out-of-range ids get zero hits, exactly like the scalar path
        # (entity_rows guards the same way) — no uint64 casts blow up
        ok = (qi >= 0) & (qi < 1 << 32)
        q = np.where(ok, qi, 0).astype(np.uint64)
        cb = np.uint64(self.cluster_bits)
        lo = np.searchsorted(keys, q << cb, side="left")
        # inclusive upper key (entity, max row): no uint64 overflow at
        # the top of the entity range
        hi = np.searchsorted(keys, (q << cb) | self._row_mask,
                             side="right")
        counts = np.where(ok, hi - lo, 0).astype(np.int64)
        lo = np.where(ok, lo, 0)
        total = int(counts.sum())
        starts = np.cumsum(counts) - counts
        within = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
        flat = within + np.repeat(lo.astype(np.int64), counts)
        rows = (keys[flat] & self._row_mask).astype(np.int64)
        qid = np.repeat(np.arange(len(q), dtype=np.int64), counts)
        sc = self.scores[rows]
        order = np.lexsort((rows, -sc, qid))
        keep = within < k          # within-group ranks survive the lexsort:
        # ``order`` permutes only inside each qid group (qid is the
        # primary key and groups were already contiguous), so group
        # sizes/offsets — and hence ``within`` — are unchanged.
        sel = order[keep]
        return qid[sel], rows[sel], sc[sel]

    def topk_batch(self, entities, mode: Optional[int] = None, k: int = 10
                   ) -> List[List[Tuple[ClusterView, float]]]:
        """Ranked hits for many entities in one pass; result ``i`` is
        bit-identical to ``topk(entities[i], mode, k)``."""
        qid, rows, sc = self.topk_batch_raw(entities, mode, k)
        out: List[List[Tuple[ClusterView, float]]] = [[] for _ in entities]
        view_at = self.index.view_at
        for i, r, s in zip(qid.tolist(), rows.tolist(), sc.tolist()):
            out[i].append((view_at(r), s))
        return out

    # -- signatures ----------------------------------------------------------

    def lookup_signatures(self, signatures) -> np.ndarray:
        """Cluster rows for a batch of (lo, hi) signature pairs in one
        ``searchsorted`` pass over the packed signature words; -1 where
        the signature is not in this snapshot."""
        sigs = np.atleast_2d(np.asarray(signatures, np.uint64))
        q = pack_signatures(sigs[:, 0], sigs[:, 1])
        if not self._sig_sorted.size:
            return np.full(q.shape, -1, np.int64)
        pos = np.searchsorted(self._sig_sorted, q)
        pos_c = np.minimum(pos, len(self._sig_sorted) - 1)
        ok = self._sig_sorted[pos_c] == q
        return np.where(ok, self._sig_order[pos_c], -1).astype(np.int64)
