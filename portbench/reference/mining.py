"""Plain NumPy reference of the paper's three-stage mining: prime OAC
(whole key segments) and NOAC (δ-ranges of values inside them), written
from the algorithm's definition, not from the program.

For each mode k the table is ordered by the key (the other columns in
order, [the value,] the mode's own column), ties by row index: the
sorted order.  A row's component along k is a window of that order:

* prime: the row's whole key segment (the rows that agree on the other
  columns);
* NOAC: inside the segment, the rows whose value lies in [v - δ, v + δ]
  (float32 arithmetic, as the configuration states).

Over a window, the mode's set signature is the sum mod 2**32 of the
hash weights of the entities at the first occurrence of each (key,
[value,] entity), one sum per 32-bit lane, and the cardinality the
count of those occurrences.  The per-mode signatures mix into a cluster
signature; rows with equal cluster signatures are one cluster.  A
cluster's generating tuples are its rows that are the first copy of
their row; the first of them by index is its unique representative.
Density is generating tuples over the product of the cardinalities, in
float32.  The hash vectors are drawn from a Philox generator, the recipe
frozen below.

``lanes=1`` and ``bfloat16=True`` give the control: one 32-bit
signature lane (``sig_hi`` zero, clusters told apart by ``sig_lo``
alone) and the densities rounded to bfloat16, the precision below the
configuration's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_M32 = np.uint64(0xFFFFFFFF)

#: Per-mode mixing multipliers of the cluster signature.
MIX = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
       0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09)
#: Final avalanche: (shift, multiplier) of the lo and the hi lane.
AVALANCHE = ((16, 0x7FEB352D), (15, 0x846CA68B))


def hash_vectors(sizes: Sequence[int], seed: int
                 ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Two uint32 weight vectors per mode, in [1, 2**32), drawn in mode
    order (lo then hi) from ``Philox(seed)``."""
    rng = np.random.Generator(np.random.Philox(seed))
    return [(rng.integers(1, 2**32, size=n, dtype=np.uint32),
             rng.integers(1, 2**32, size=n, dtype=np.uint32))
            for n in sizes]


def _starts(cols: Sequence[np.ndarray]) -> np.ndarray:
    """True where a sorted row differs from the one before in any column
    (and at row 0)."""
    t = cols[0].shape[0]
    flag = np.zeros(t, bool)
    flag[:1] = True
    for c in cols:
        flag[1:] |= c[1:] != c[:-1]
    return flag


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    returned as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> np.uint64(16)) & np.uint64(1))) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _window_sums(weight: np.ndarray, first: np.ndarray, lo: np.ndarray,
                 hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(sum mod 2**32 of ``weight`` where ``first``, count of ``first``)
    over the sorted windows [lo, hi)."""
    w = np.where(first, weight, 0).astype(np.uint64)
    pref = np.concatenate([[0], np.cumsum(w)]).astype(np.uint64)
    cnt = np.concatenate([[0], np.cumsum(first)]).astype(np.int64)
    return ((pref[hi] - pref[lo]) & _M32).astype(np.uint32), \
        (cnt[hi] - cnt[lo]).astype(np.int32)


def _mode(tuples, k, values, delta, vecs):
    """One mode: (perm, sorted entities, window lo, hi, per-lane
    signatures, cardinality, first-occurrence flags in sorted order),
    windows in row order."""
    t, n = tuples.shape
    others = [tuples[:, j] for j in range(n) if j != k]
    keys = [tuples[:, k]] + ([values] if values is not None else []) \
        + others[::-1]
    perm = np.lexsort(keys)
    s_others = [c[perm] for c in others]
    s_e = tuples[perm, k]
    s_vals = values[perm] if values is not None else None
    starts = _starts(s_others)
    seg = np.cumsum(starts) - 1
    seg_lo = np.flatnonzero(starts)
    seg_hi = np.append(seg_lo[1:], t)
    first = _starts(s_others + ([s_vals] if s_vals is not None else [])
                    + [s_e])
    pos = np.arange(t)
    inv = np.empty(t, np.int64)
    inv[perm] = pos
    if values is None:
        lo, hi = seg_lo[seg][inv], seg_hi[seg][inv]
    else:
        # value ranks make (segment, value) one ascending integer key
        # along sorted order; the queries ascend too, so are found in
        # sorted order and mapped back to rows
        d = np.float32(delta)
        dom = np.unique(np.concatenate([s_vals, s_vals - d, s_vals + d]))
        width = np.int64(dom.size + 1)
        comp = seg * width + np.searchsorted(dom, s_vals)
        lo = np.searchsorted(comp, seg * width
                             + np.searchsorted(dom, s_vals - d),
                             side="left")[inv]
        hi = np.searchsorted(comp, seg * width
                             + np.searchsorted(dom, s_vals + d),
                             side="right")[inv]
    sigs = [_window_sums(r[s_e], first, lo, hi)[0] for r in vecs]
    card = _window_sums(vecs[0][s_e], first, lo, hi)[1]
    return perm, s_e, lo, hi, sigs, card, first, inv


def _mix(per_mode: List[np.ndarray], lane: int) -> np.ndarray:
    acc = np.zeros(per_mode[0].shape, np.uint64)
    for k, s in enumerate(per_mode):
        acc = (acc + np.uint64(MIX[(k + 3 * lane) % len(MIX)])
               * s.astype(np.uint64)) & _M32
    shift, mult = AVALANCHE[lane]
    acc = acc ^ (acc >> np.uint64(shift))
    return ((acc * np.uint64(mult)) & _M32).astype(np.uint32)


def mine(tuples: np.ndarray, sizes: Sequence[int], *, hash_seed: int,
         values: Optional[np.ndarray] = None, delta: Optional[float] = None,
         theta: float = 0.0, minsup: int = 0, lanes: int = 2,
         bfloat16: bool = False) -> Dict[str, np.ndarray]:
    """Every leaf the benchmark compares, in row order: ``sig_lo``,
    ``sig_hi`` (uint32), ``gen_count``, ``keep``, ``density`` (float32),
    and per mode (N, T): ``cardinalities``, ``range_lo``, ``range_hi``,
    ``sorted_e``.  ``density_exact`` is the float64 quotient the
    float32 density rounds.  ``delta=None`` mines prime OAC."""
    tuples = np.asarray(tuples, np.int64)
    t, n = tuples.shape
    vals = None
    if delta is not None:
        vals = np.asarray(values, np.float32)
    vecs = hash_vectors(sizes, hash_seed)
    modes = [_mode(tuples, k, vals, delta, vecs[k]) for k in range(n)]
    sig_lo = _mix([m[4][0] for m in modes], 0)
    sig_hi = (_mix([m[4][1] for m in modes], 1) if lanes == 2
              else np.zeros(t, np.uint32))
    cards = np.stack([m[5] for m in modes])
    volume = np.ones(t, np.float32)
    for c in cards:
        volume = volume * c.astype(np.float32)
    # a row is generating when it is the first copy of itself: mode 0's
    # key spans the whole row (and the value)
    first_row = modes[0][6][modes[0][7]]
    key = (sig_hi.astype(np.uint64) << np.uint64(32)) | sig_lo
    _, cluster = np.unique(key, return_inverse=True)
    cluster = cluster.reshape(-1)
    gen = np.bincount(cluster, weights=first_row).astype(np.int32)[cluster]
    rep = np.full(cluster.max() + 1, t, np.int64)
    np.minimum.at(rep, cluster, np.where(first_row, np.arange(t), t))
    unique = first_row & (rep[cluster] == np.arange(t))
    exact = gen.astype(np.float64) / np.maximum(
        cards.astype(np.float64).prod(0), 1.0)
    density = gen.astype(np.float32) / np.maximum(volume, np.float32(1))
    if bfloat16:
        density = to_bfloat16(density)
    keep = unique & (density >= np.float32(theta))
    if minsup:
        keep &= (cards >= minsup).all(0)
    return {
        "sig_lo": sig_lo, "sig_hi": sig_hi, "gen_count": gen, "keep": keep,
        "density": density, "density_exact": exact, "cardinalities": cards,
        "range_lo": np.stack([m[2] for m in modes]).astype(np.int32),
        "range_hi": np.stack([m[3] for m in modes]).astype(np.int32),
        "sorted_e": np.stack([m[1] for m in modes]).astype(np.int32),
    }
