"""Shared Stage-1/2/3 mining pipeline — the one skeleton behind every
engine.  Port of ``repro.core.pipeline``.

The paper's M/R algorithm is the *same* three jobs for the prime OAC and
many-valued (NOAC) variants; only the per-key *component operator*
differs:

  Stage 1  ``sort_mode``            per-mode sort of the tuple table by
           the mode's shuffle key (the N-1 "other" columns, plus the
           value column for many-valued contexts) and segmentation of
           the sorted order.  When the key fits 64 bits it is ONE stable
           sort over the packed key word(s) — the radix backend
           (``core.radix``) by default, or one stable ``torch.sort``
           (``sort_backend='lax'``); otherwise the column lexsort.
  comp-op  ``prime_components``     cumulus = the whole key segment.
           ``delta_components``     δ-range inside the key segment.
  Stage 2  ``mix_signatures``       per-mode ⟨signature, cardinality⟩
           aggregates gathered back to each generating tuple.
  Stage 3  ``stage3_dedup``         dedup + distinct generating-tuple
           counts on 2×32-bit set signatures, via one more sort.

All signatures are order-independent modular sums of first-occurrence-
masked hash weights, held as int32 bit patterns (``core.bits``): the
port gives the JAX package's results bit for bit.  PyTorch runs eagerly,
so there is no jit; every tensor lives on the tuples' device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as kops
from . import keys as K
from . import radix as RX
from . import runs as RS
from .bits import SIGN, as_uint32, from_uint32, i32, srl


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------

# Per-mode multipliers for mixing mode signatures into a cluster signature.
# Odd constants (invertible mod 2^32) from splitmix64 / Weyl sequences.
_MIX = np.array([0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
                 0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09],
                dtype=np.uint32)


def mode_hash_vectors(sizes: Sequence[int], seed: int = 0x5EED):
    """Two independent uint32 hash vectors per mode (host-side, fixed seed).

    Every engine built from the same (sizes, seed) produces bit-identical
    cluster signatures — the cross-backend (and cross-package) parity
    guarantee."""
    rng = np.random.Generator(np.random.Philox(seed))
    return [
        (rng.integers(1, 2**32, size=n, dtype=np.uint32),
         rng.integers(1, 2**32, size=n, dtype=np.uint32))
        for n in sizes
    ]


def hash_vectors_from_numpy(vecs, device=None):
    """The port's hash lanes from ``mode_hash_vectors`` output (either
    package's: lists of ``np.uint32`` (lo, hi) pairs) -> (lo list, hi
    list) of int32 bit-pattern tensors on ``device``."""
    return ([from_uint32(lo, device) for lo, _ in vecs],
            [from_uint32(hi, device) for _, hi in vecs])


def mix_signatures(per_mode_lo, per_mode_hi):
    """Combine per-mode set signatures into one 2×32-bit cluster signature."""
    lo = torch.zeros_like(per_mode_lo[0])
    hi = torch.zeros_like(per_mode_hi[0])
    for k, (slo, shi) in enumerate(zip(per_mode_lo, per_mode_hi)):
        lo = lo + i32(_MIX[k % len(_MIX)]) * slo
        hi = hi + i32(_MIX[(k + 3) % len(_MIX)]) * shi
    # final avalanche
    lo = (lo ^ srl(lo, 16)) * i32(0x7FEB352D)
    hi = (hi ^ srl(hi, 15)) * i32(0x846CA68B)
    return lo, hi


# ---------------------------------------------------------------------------
# Sorting / segmentation primitives
# ---------------------------------------------------------------------------

def lex_perm(columns: Sequence[torch.Tensor]) -> torch.Tensor:
    """int32 permutation sorting rows lexicographically by ``columns``
    (first column most significant): stable sorts column by column from
    the least significant.  Columns compare signed — flip the sign bit of
    uint32 bit-pattern columns first."""
    perm = torch.arange(columns[0].shape[0], device=columns[0].device)
    for c in reversed(list(columns)):
        _, idx = torch.sort(c[perm], stable=True)
        perm = perm[idx]
    return perm.to(torch.int32)


def segment_starts(sorted_key_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Boolean start-of-segment flags for already-sorted key columns."""
    c0 = sorted_key_cols[0]
    change = torch.zeros((c0.shape[0],), dtype=torch.bool, device=c0.device)
    change[:1] = True
    for c in sorted_key_cols:
        change[1:] |= c[1:] != c[:-1]
    return change


def segment_bounds(flags: torch.Tensor):
    """Per sorted position: the [a, b) window of its own run, where
    ``flags`` marks run starts (``flags[0]`` must be True): a forward
    cummax and a flipped cummin."""
    t = flags.shape[0]
    pos = torch.arange(t, dtype=torch.int32, device=flags.device)
    a = torch.cummax(torch.where(flags, pos, 0), 0).values
    suff = torch.cummin(torch.where(flags, pos, t).flip(0), 0).values.flip(0)
    b = torch.cat([suff[1:], torch.full((1,), t, dtype=torch.int32,
                                        device=flags.device)])
    return a.to(torch.int32), b.to(torch.int32)


@dataclasses.dataclass
class SortedMode:
    """Stage-1 output for one mode: the tuple table sorted by the mode's
    shuffle key and segmented by it.  All tensors have length T and are
    indexed by *sorted* position; ``seg_a``/``seg_b`` delimit each
    position's own key segment as a half-open window of sorted order."""
    perm: torch.Tensor         # sorted order of tuples
    inv: torch.Tensor          # inverse permutation (original → sorted pos)
    seg_a: torch.Tensor        # segment start per sorted position
    seg_b: torch.Tensor        # segment end (exclusive) per sorted position
    sorted_e: torch.Tensor     # mode-k entity column under perm
    sorted_vals: Optional[torch.Tensor]  # values under perm (None: prime)
    first_occ: torch.Tensor    # per sorted position: first of its
                               # identical (key[, value], e) run
    sorted_words: Optional[tuple] = None  # packed key words (packed path)
    plan: Optional[K.ModeKeyPlan] = None  # the key layout (packed path)


def mode_key_columns(tuples: torch.Tensor, k: int,
                     values: Optional[torch.Tensor] = None):
    """Mode ``k``'s lexicographic sort-key columns — (others..., [value,]
    e_k) — as (others, tail) lists: THE column order of Stage 1's sort."""
    n = tuples.shape[1]
    others = [tuples[:, j] for j in range(n) if j != k]
    tail = ([values] if values is not None else []) + [tuples[:, k]]
    return others, tail


def mode_sort_perm(tuples: torch.Tensor, k: int,
                   values: Optional[torch.Tensor] = None,
                   plan: Optional[K.ModeKeyPlan] = None,
                   sort_backend: str = "radix",
                   use_kernels: Optional[bool] = None,
                   value_domain: Optional[torch.Tensor] = None):
    """Exactly Stage 1's sort — the part the sort backend swaps: key
    packing + the stable word sort (packed plans) or the column lexsort.
    Returns (perm, sorted_words-or-None)."""
    t = tuples.shape[0]
    if plan is not None and plan.fits:
        words = plan.pack_device(tuples, values, domain=value_domain)
        iota = torch.arange(t, dtype=torch.int32, device=tuples.device)
        s_words, (perm,) = K.sort_with_payload(
            words, (iota,), backend=sort_backend, live_bits=plan.total_bits,
            use_kernels=use_kernels)
        return perm, s_words
    others, tail = mode_key_columns(tuples, k, values)
    return lex_perm(others + tail), None


def sort_mode(tuples: torch.Tensor, k: int,
              values: Optional[torch.Tensor] = None,
              perm: Optional[torch.Tensor] = None,
              plan: Optional[K.ModeKeyPlan] = None,
              sort_backend: str = "radix",
              use_kernels: Optional[bool] = None,
              value_domain: Optional[torch.Tensor] = None) -> SortedMode:
    """Stage 1 for mode k.  Sort key: (other columns..., [value,] e_k), so
    duplicates of a (key[, value], e) pair land adjacent and the
    ``first_occ`` mask makes all downstream sums duplicate-idempotent.

    ``plan`` (a fitting ``keys.ModeKeyPlan``) selects the packed-key
    path: the entity and value columns are decoded from the sorted key's
    bit-fields, and segment/first-occurrence flags are 1–2 word
    comparisons.  Without a plan the column lexsort runs.  All paths give
    the same result.  ``perm`` short-circuits the sort with a precomputed
    permutation."""
    t, n = tuples.shape
    s_words = None
    if plan is not None and plan.fits:
        if perm is None:
            perm, s_words = mode_sort_perm(tuples, k, values, plan,
                                           sort_backend, use_kernels,
                                           value_domain)
        else:
            words = plan.pack_device(tuples, values, domain=value_domain)
            s_words = tuple(w[perm] for w in words)
        s_vals = (plan.extract_values(s_words, domain=value_domain)
                  if values is not None else None)
        s_e = plan.extract_entity(s_words)
        seg_flag = segment_starts(K.drop_low_bits(s_words, plan.seg_shift))
        first_occ = segment_starts(s_words)
    else:
        plan = None
        others, tail = mode_key_columns(tuples, k, values)
        if perm is None:
            perm = lex_perm(others + tail)
        s_others = [c[perm] for c in others]
        s_e = tuples[perm, k]
        s_vals = values[perm] if values is not None else None
        seg_flag = segment_starts(s_others)
        first_occ = segment_starts(
            s_others + ([s_vals] if s_vals is not None else []) + [s_e])
    seg_a, seg_b = segment_bounds(seg_flag)
    pos = torch.arange(t, dtype=torch.int32, device=tuples.device)
    inv = torch.zeros((t,), dtype=torch.int32, device=tuples.device)
    inv[perm] = pos
    return SortedMode(perm, inv, seg_a, seg_b, s_e, s_vals, first_occ,
                      s_words, plan)


# ---------------------------------------------------------------------------
# Component operators (the pluggable part)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ModeComponents:
    """One mode's component per tuple, in *original* tuple order.

    ``range_lo``/``range_hi`` delimit the component as a half-open window
    of the mode's sorted order."""
    sig_lo: torch.Tensor     # order-independent set hash of the component
    sig_hi: torch.Tensor
    card: torch.Tensor       # distinct entity count
    range_lo: torch.Tensor   # window start in sorted order
    range_hi: torch.Tensor   # window end (exclusive)


def masked_prefix(w_lo: torch.Tensor, w_hi: torch.Tensor,
                  first_occ: torch.Tensor,
                  use_kernels: Optional[bool] = None):
    """Exclusive (length T+1) prefix sums of first-occurrence-masked hash
    weights and of the mask — the one segment-reduction sweep both
    component operators consume (``kernels.ops.segment_reduce_exclusive``;
    on the card the kernel writes this layout, with no copy after it)."""
    return kops.segment_reduce_exclusive(w_lo, w_hi, first_occ,
                                         use_kernels=use_kernels)


def prime_components(sm: SortedMode, r_lo: torch.Tensor, r_hi: torch.Tensor,
                     use_kernels: Optional[bool] = None) -> ModeComponents:
    """Prime cumulus operator (Alg. 2+3): the component of a tuple along a
    mode is its *whole* key segment.  Signatures/cardinalities are
    boundary differences of the fused masked prefix sums (wrapping int32
    arithmetic makes them exactly the segment sums mod 2³²)."""
    pref_lo, pref_hi, pref_cnt = masked_prefix(
        r_lo[sm.sorted_e], r_hi[sm.sorted_e], sm.first_occ, use_kernels)
    a = sm.seg_a[sm.inv]
    b = sm.seg_b[sm.inv]
    return ModeComponents(pref_lo[b] - pref_lo[a], pref_hi[b] - pref_hi[a],
                          pref_cnt[b] - pref_cnt[a], a, b)


def bsearch(vals: torch.Tensor, lo0: torch.Tensor, hi0: torch.Tensor,
            target: torch.Tensor, leq: bool) -> torch.Tensor:
    """Vectorised binary search. Returns, per query, the first index in
    [lo0, hi0) where vals[idx] >= target (leq=False: lower bound) or
    vals[idx] > target (leq=True: upper bound); hi0 if none."""
    t = vals.shape[0]
    iters = max(1, int(np.ceil(np.log2(max(t, 2)))) + 1)
    lo, hi = lo0, hi0
    for _ in range(iters):
        mid = (lo + hi) // 2
        v = vals[torch.clamp(mid, 0, t - 1)]
        go_right = (v <= target) if leq else (v < target)
        go_right = go_right & (lo < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | (lo >= hi), hi, mid)
    return lo


def _f32(x: float, device) -> torch.Tensor:
    """A float32 scalar tensor: arithmetic with it rounds as float32."""
    return torch.tensor(np.float32(x), dtype=torch.float32, device=device)


def delta_components(sm: SortedMode, r_lo: torch.Tensor, r_hi: torch.Tensor,
                     values: torch.Tensor, delta: float,
                     use_kernels: Optional[bool] = None,
                     value_domain: Optional[torch.Tensor] = None
                     ) -> ModeComponents:
    """δ-range operator (NOAC): the component of a tuple with value v0 is
    the contiguous value-window [v0-δ, v0+δ] *inside* its key segment,
    found with two binary searches.  Signatures are differences of the
    fused masked prefix sums."""
    pref_lo, pref_hi, pref_cnt = masked_prefix(
        r_lo[sm.sorted_e], r_hi[sm.sorted_e], sm.first_occ, use_kernels)
    d = _f32(delta, values.device)
    if sm.sorted_words is not None and sm.plan is not None \
            and sm.plan.with_values:
        # packed path: δ-window bounds by *global* search over the sorted
        # key words — the query key carries the tuple's own subrelation
        # prefix with the value lane set to v∓δ and e_k at its extreme,
        # so the search self-clamps to the segment.  -0.0 targets are
        # normalised so word order agrees with float order.
        plan = sm.plan
        t_lo, t_hi = sm.sorted_vals - d, sm.sorted_vals + d
        if plan.value_bits == 32:
            zero = _f32(0.0, values.device)
            t_lo = torch.where(t_lo == 0, zero, t_lo)
            t_hi = torch.where(t_hi == 0, zero, t_hi)
            lane_lo = K.float_sort_bits(t_lo)
            lane_hi = K.float_sort_bits(t_hi)
        else:
            # rank-coded lane: every value ≥ v-δ has rank ≥
            # searchsorted-left(v-δ); every value ≤ v+δ has rank ≤
            # searchsorted-right(v+δ)-1.
            dom = value_domain.to(torch.float32).contiguous()
            lane_lo = torch.searchsorted(dom, t_lo, side="left").to(
                torch.int32)
            lane_hi = (torch.searchsorted(dom, t_hi, side="right")
                       - 1).to(torch.int32)
        q_lo = plan.delta_query_words(sm.sorted_words, lane_lo)
        q_hi = plan.delta_query_words(sm.sorted_words, lane_hi)
        q_hi = q_hi[:-1] + (q_hi[-1] | plan.e_mask,)
        lo_idx = K.search_words(sm.sorted_words, q_lo, upper=False)[sm.inv]
        hi_idx = K.search_words(sm.sorted_words, q_hi, upper=True)[sm.inv]
    else:
        a = sm.seg_a[sm.inv]
        b = sm.seg_b[sm.inv]
        lo_idx = bsearch(sm.sorted_vals, a, b, values - d, leq=False)
        hi_idx = bsearch(sm.sorted_vals, a, b, values + d, leq=True)
    return ModeComponents(pref_lo[hi_idx] - pref_lo[lo_idx],
                          pref_hi[hi_idx] - pref_hi[lo_idx],
                          pref_cnt[hi_idx] - pref_cnt[lo_idx],
                          lo_idx.to(torch.int32), hi_idx.to(torch.int32))


# ---------------------------------------------------------------------------
# Stage 3: dedup + generating-tuple counts
# ---------------------------------------------------------------------------

def stage3_dedup(sig_lo: torch.Tensor, sig_hi: torch.Tensor,
                 tuple_first: torch.Tensor, packed: bool = True,
                 sort_backend: str = "radix",
                 use_kernels: Optional[bool] = None):
    """Dedup clusters on their signatures with one sort; count *distinct*
    generating tuples per cluster (Alg. 6+7 reducer semantics).

    ``packed`` keys the sort on the (sig_lo, sig_hi) pair as one 64-bit
    word, all 64 bits live for the radix backend; the lexsort branch
    sorts the two columns as unsigned.

    Returns (gen_count, is_unique) in original tuple order; ``is_unique``
    marks the first distinct generating tuple of each cluster."""
    t = sig_lo.shape[0]
    dev = sig_lo.device
    if packed:
        iota = torch.arange(t, dtype=torch.int32, device=dev)
        (s_lo, s_hi), (order,) = K.sort_with_payload(
            (sig_lo, sig_hi), (iota,), backend=sort_backend, live_bits=64,
            use_kernels=use_kernels)
    else:
        order = lex_perm([sig_lo ^ SIGN, sig_hi ^ SIGN])
        s_lo, s_hi = sig_lo[order], sig_hi[order]
    s_first = tuple_first[order]
    cstart = segment_starts([s_lo, s_hi])
    a, b = segment_bounds(cstart)
    # distinct generating tuples per cluster: prefix-count differences at
    # the cluster window bounds; a tuple is the cluster's unique
    # representative iff it is the window's first s_first entry.
    pref = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                      torch.cumsum(s_first.to(torch.int32), 0,
                                   dtype=torch.int32)])
    pos = torch.arange(t, dtype=torch.int32, device=dev)
    uniq_sorted = s_first & (pref[pos] == pref[a])
    inv_order = torch.zeros((t,), dtype=torch.int32, device=dev)
    inv_order[order] = pos
    gen_of = (pref[b] - pref[a])[inv_order]
    is_unique = uniq_sorted[inv_order]
    return gen_of, is_unique


# ---------------------------------------------------------------------------
# The full pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineResult:
    """Unified per-tuple mining output (original tuple order; length-T
    tensors), shared by every backend and variant.  Signatures are int32
    bit patterns of the JAX package's uint32 signatures."""
    sig_lo: torch.Tensor        # cluster signature of the tuple's cluster
    sig_hi: torch.Tensor
    is_unique: torch.Tensor     # bool: first distinct generating tuple
    gen_count: torch.Tensor     # distinct generating tuples of the cluster
    volume: torch.Tensor        # float32 Π_k |component_k|
    density: torch.Tensor       # Alg. 7 estimate  gen_count / volume
    keep: torch.Tensor          # unique & density ≥ θ (& minsup)
    cardinalities: torch.Tensor  # (N, T) distinct |component_k| per tuple
    range_lo: torch.Tensor      # (N, T) component window starts (sorted ord.)
    range_hi: torch.Tensor      # (N, T) window ends (exclusive)
    sorted_e: torch.Tensor      # (N, T) per-mode entity columns, sorted order
    perms: torch.Tensor         # (N, T) per-mode sort permutations


def mine_tuples(tuples: torch.Tensor, hash_lo: Sequence[torch.Tensor],
                hash_hi: Sequence[torch.Tensor], *,
                values: Optional[torch.Tensor] = None,
                delta: Optional[float] = None, theta: float = 0.0,
                minsup: int = 0,
                perms: Optional[torch.Tensor] = None,
                packed: Optional[bool] = None,
                sort_backend: Optional[str] = None,
                use_kernels: Optional[bool] = None,
                value_domain: Optional[torch.Tensor] = None
                ) -> PipelineResult:
    """The full three-stage pipeline on one device (that of ``tuples``).

    ``delta=None`` runs the prime cumulus operator (multimodal/OAC);
    otherwise the δ-range operator (NOAC) with ``theta`` acting as ρ_min
    and ``minsup`` as the per-mode minimal cardinality.  ``perms``
    (N, T) supplies precomputed per-mode sort orders.

    ``packed`` selects the single-word Stage-1/3 sort path (None: packed
    whenever the context's key fits 64 bits; False: always lexsort);
    ``sort_backend`` picks the word sort ('radix' or 'lax'; 'lexsort'
    forces the column path).  ``use_kernels`` routes the segment
    reductions and the radix sweeps through the CUDA kernels (None: when
    the tuples lie on CUDA).  ``value_domain`` — the sorted distinct
    values of the many-valued column — prunes the key's value lane to
    rank width; orderings are unchanged."""
    t, n = tuples.shape
    if delta is not None and delta < 0:
        raise ValueError(f"delta must be >= 0, got {delta}")
    if values is None:
        value_domain = None
    plans = K.plan_context_keys(
        [h.shape[0] for h in hash_lo], with_values=values is not None,
        value_slots=(None if value_domain is None
                     else value_domain.shape[0]))
    backend = RX.resolve_sort_backend(sort_backend, packed, plans[0].fits)
    use_packed = backend != "lexsort"
    # the (sig_lo, sig_hi) pair always fits two words, so Stage 3 keeps
    # its packed sort even when the context's own key does not fit
    s3_backend = RX.resolve_sort_backend(sort_backend, packed, True)
    comps, sms = [], []
    for k in range(n):
        sm = sort_mode(tuples, k, values=values,
                       perm=None if perms is None else perms[k],
                       plan=plans[k] if use_packed else None,
                       sort_backend=backend, use_kernels=use_kernels,
                       value_domain=value_domain)
        if delta is None:
            comps.append(prime_components(sm, hash_lo[k], hash_hi[k],
                                          use_kernels))
        else:
            comps.append(delta_components(sm, hash_lo[k], hash_hi[k],
                                          values, delta, use_kernels,
                                          value_domain=value_domain))
        sms.append(sm)
    # Stage 2: per-tuple cluster = mix of per-mode component aggregates.
    sig_lo, sig_hi = mix_signatures([c.sig_lo for c in comps],
                                    [c.sig_hi for c in comps])
    volume = torch.ones((t,), dtype=torch.float32, device=tuples.device)
    for c in comps:
        volume = volume * c.card.to(torch.float32)
    # Stage 3.  Mode 0's sort key covers the whole row, so its
    # first-of-run flags already mark the lowest-index copy of each
    # duplicate row (stable sorts) — no extra full-table sort needed.
    tfirst = sms[0].first_occ[sms[0].inv]
    gen_of, is_unique = stage3_dedup(sig_lo, sig_hi, tfirst,
                                     packed=s3_backend != "lexsort",
                                     sort_backend=s3_backend,
                                     use_kernels=use_kernels)
    density = gen_of.to(torch.float32) / torch.clamp(volume, min=1.0)
    keep = is_unique & (density >= _f32(theta, tuples.device))
    if minsup:
        for c in comps:
            keep = keep & (c.card >= minsup)
    return PipelineResult(
        sig_lo, sig_hi, is_unique, gen_of, volume, density, keep,
        cardinalities=torch.stack([c.card for c in comps]),
        range_lo=torch.stack([c.range_lo for c in comps]),
        range_hi=torch.stack([c.range_hi for c in comps]),
        sorted_e=torch.stack([sm.sorted_e for sm in sms]),
        perms=torch.stack([sm.perm.to(torch.int32) for sm in sms]))


# ---------------------------------------------------------------------------
# Host-side materialisation
# ---------------------------------------------------------------------------

def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def materialise(result: PipelineResult, only_kept: bool = True):
    """Extract cluster component sets [(components, density), ...] for kept
    (or all unique) tuples by slicing the per-mode sorted windows."""
    flag = _np(result.keep if only_kept else result.is_unique)
    rlo, rhi = _np(result.range_lo), _np(result.range_hi)
    sorted_e = _np(result.sorted_e)
    dens = _np(result.density)
    n = sorted_e.shape[0]
    out = []
    for i in np.nonzero(flag)[0]:
        comps = []
        for k in range(n):
            window = sorted_e[k][rlo[k, i]:rhi[k, i]]
            comps.append(frozenset(np.unique(window).tolist()))
        out.append((tuple(comps), float(dens[i])))
    return out


def kept_sig_words(result) -> np.ndarray:
    """Sorted packed ``(sig_hi << 32) | sig_lo`` words of the kept
    clusters of one result — the per-snapshot signature *set* the
    serving layer diffs to find dirty clusters."""
    keep = _np(result.keep).astype(bool)
    lo = as_uint32(result.sig_lo)[keep].astype(np.uint64)
    hi = as_uint32(result.sig_hi)[keep].astype(np.uint64)
    return np.unique((hi << np.uint64(32)) | lo)


def dirty_sig_count(prev: Optional[np.ndarray],
                    cur: np.ndarray) -> int:
    """Size of the symmetric difference of two sorted signature-word
    sets — how many clusters changed identity between two consecutive
    snapshots."""
    if prev is None:
        return int(cur.size)
    inter = np.intersect1d(cur, prev, assume_unique=True).size
    return int(cur.size) + int(prev.size) - 2 * int(inter)


def _active_obs(obs):
    """The enabled observability hub or None — the pipeline's
    zero-overhead-when-disabled gate.  Duck-typed (``.enabled``,
    ``.metrics``, ``.tracer``) so ``core`` never imports
    ``repro_torch.obs``; callers pass a ``repro_torch.obs.Obs`` (or
    nothing)."""
    return obs if (obs is not None
                   and getattr(obs, "enabled", False)) else None


def timer_sync(device: torch.device) -> None:
    """Wait for the work queued on ``device`` before a stage timer reads
    the clock (CUDA runs asynchronously; the CPU's ops have finished when
    they return).  Called only when profiling is on."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    np_dtype = {torch.int32: np.int32, torch.float32: np.float32}[dtype]
    return torch.from_numpy(np.ascontiguousarray(x, np_dtype)).to(device)


class PipelineMiner:
    """Base driver: the single-device pipeline over fixed mode sizes.

    Subclasses (``BatchMiner``, ``NOACMiner``) pin the component operator;
    everything else — hashing, materialisation, the out-of-core paths
    (:meth:`mine_chunked`, :meth:`mine_windowed`, whose default budget is
    ``window_budget``) — is shared; ``streaming.StreamingMiner`` adds
    ingestion and snapshots.  ``device``
    defaults to CUDA and raises without a card (``device="cpu"`` runs the
    plain versions of the kernels on the CPU).

    ``obs`` (an enabled ``repro_torch.obs.Obs``) turns on per-stage
    wall-time profiling: host run-sort vs device mine split, per-window
    stage timings and memory peaks on the windowed path.  A stage timer
    synchronises the device before it reads the clock.  ``obs=None``
    (the default) queues exactly the work an unprofiled run queues: no
    synchronisation, no host read."""

    def __init__(self, sizes: Sequence[int], *, theta: float = 0.0,
                 delta: Optional[float] = None, minsup: int = 0,
                 seed: int = 0x5EED, packed: Optional[bool] = None,
                 sort_backend: Optional[str] = None,
                 use_kernels: Optional[bool] = None,
                 prune_values: bool = True,
                 window_budget: Optional[int] = None,
                 device=None, obs=None):
        self.obs = obs
        self.device = resolve_device(device)
        self.sizes = tuple(int(s) for s in sizes)
        self.window_budget = (None if window_budget is None
                              else int(window_budget))
        self.theta = float(theta)
        self.delta = None if delta is None else float(delta)
        if self.delta is not None and self.delta < 0:
            # a negative δ makes the window [v-δ, v+δ] empty; the rank-
            # coded lane's searchsorted bounds would underflow instead
            raise ValueError(f"delta must be >= 0, got {self.delta}")
        self.minsup = int(minsup)
        self.packed = packed
        self.sort_backend = sort_backend
        self.use_kernels = use_kernels
        self.prune_values = bool(prune_values)
        self.key_plans = K.plan_context_keys(self.sizes,
                                             with_values=delta is not None)
        self._lo, self._hi = hash_vectors_from_numpy(
            mode_hash_vectors(self.sizes, seed), self.device)

    @property
    def resolved_sort_backend(self) -> str:
        """The actual Stage-1 sort path: 'radix' | 'lax' | 'lexsort'."""
        return RX.resolve_sort_backend(self.sort_backend, self.packed,
                                       self.key_plans[0].fits)

    @property
    def packed_active(self) -> bool:
        """True when Stage 1 runs the packed single-sort path."""
        return self.resolved_sort_backend != "lexsort"

    def value_domain(self, values) -> Optional[torch.Tensor]:
        """Sorted distinct values for lane pruning (None when pruning is
        off or the caller forced the lexsort path — the shared
        ``radix.wants_value_pruning`` gate)."""
        if values is None or not RX.wants_value_pruning(
                self.prune_values, self.packed, self.sort_backend):
            return None
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        return torch.from_numpy(K.value_domain_host(values)).to(self.device)

    def __call__(self, tuples, values=None) -> PipelineResult:
        obs = _active_obs(self.obs)
        t0 = time.perf_counter() if obs is not None else 0.0
        res = self._mine_incore(tuples, values)
        if obs is not None:
            # profiling waits for the queued mine: the figure is the
            # device's wall time, and the next stage's timer starts clean
            timer_sync(self.device)
            obs.metrics.histogram(
                "pipeline_stage_ms", stage="mine_monolithic").observe(
                    (time.perf_counter() - t0) * 1e3)
        return res

    def _mine_incore(self, tuples, values=None) -> PipelineResult:
        """The in-core pipeline of one table, Stage 1 sorting on the
        device (unprofiled: :meth:`__call__` times it)."""
        tuples = _as_tensor(tuples, torch.int32, self.device)
        if self.delta is not None:
            if values is None:
                values = np.zeros((tuples.shape[0],), np.float32)
            # domain from the caller's (usually host-side) array, before
            # the device transfer
            vdom = self.value_domain(values)
            values = _as_tensor(values, torch.float32, self.device)
        else:
            values, vdom = None, None
        return mine_tuples(tuples, self._lo, self._hi, values=values,
                           delta=self.delta, theta=self.theta,
                           minsup=self.minsup, packed=self.packed,
                           sort_backend=self.sort_backend,
                           use_kernels=self.use_kernels,
                           value_domain=vdom)

    def materialise(self, result: PipelineResult, tuples=None,
                    only_kept: bool = True):
        """``tuples`` is accepted for API compatibility and unused — the
        result carries its own component windows."""
        return materialise(result, only_kept)

    def mine_chunked(self, chunks, values=None,
                     chunk_budget: Optional[int] = None,
                     stats: Optional[dict] = None) -> PipelineResult:
        """Out-of-core chunked Stage 1: build a host-side
        ``core.runs.RunStore`` chunk by chunk — each chunk sorted with
        O(chunk) working set, runs merged linearly — and hand the merged
        per-mode permutations to ``mine_tuples`` via ``perms``, so the
        device never sorts in Stage 1 and the host never holds more than
        the row log plus one chunk's sort scratch.  Bit-identical to the
        in-core ``__call__`` on the same table (the store's host packers
        are the device packers, and stable merges keep the sort order).

        ``chunks`` is a single (T, N) table or an iterable of row chunks
        (``values`` aligned likewise for the δ variant); ``chunk_budget``
        bounds rows per chunk, re-splitting anything larger.  A budget
        *smaller than the largest key segment* is fine — chunk runs merge
        stably, so a segment spanning many chunks reassembles exactly;
        only degenerate budgets (< 1) raise.  Valued tables get the
        constructor's last-write-wins canonicalisation (``core.runs``) —
        already-canonical contexts pass through unchanged.  Contexts
        whose key exceeds 64 bits fall back to one device sort of the
        assembled table."""
        if chunk_budget is not None and int(chunk_budget) < 1:
            raise ValueError(
                f"chunk_budget must be >= 1, got {chunk_budget}; pass "
                "None to ingest chunks as offered")
        obs = _active_obs(self.obs)
        t0 = time.perf_counter() if obs is not None else 0.0
        store = self._sorted_store(chunks, values, chunk_budget, stats)
        if obs is not None:
            # the host run sort IS Stage 1's sort on this path
            obs.metrics.histogram(
                "pipeline_stage_ms", stage="stage1_sort").observe(
                    (time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
        rows, vals = store.table()
        perms = store.perms()
        if perms is None:      # key exceeds 64 bits: no host runs
            # one device sort of the assembled table — with the same
            # value-lane pruning __call__ applies, so a key rescued by
            # the rank-coded lane still takes the packed path
            res = self._mine_incore(rows, vals)
        else:
            res = self._mine_unpruned(rows, vals, perms)
        if obs is not None:
            timer_sync(self.device)
            obs.metrics.histogram(
                "pipeline_stage_ms", stage="device_mine").observe(
                    (time.perf_counter() - t0) * 1e3)
        return res

    def _sorted_store(self, chunks, values, budget, stats) -> RS.RunStore:
        """A prepared host ``RunStore`` of the chunks, each re-split to at
        most ``budget`` rows and sorted on arrival (no runs when the key
        exceeds 64 bits)."""
        store = RS.RunStore(self.key_plans,
                            radix=self.resolved_sort_backend == "radix",
                            incremental=self.key_plans[0].fits,
                            stats=stats if stats is not None else {})
        for rows, vals in RS.iter_chunks(chunks, values, budget,
                                         with_values=self.delta is not None):
            store.add(rows, vals)
        store.prepare()
        if store.count == 0:
            raise ValueError("no data ingested")
        return store

    def _mine_unpruned(self, rows, vals, perms=None) -> PipelineResult:
        """``mine_tuples`` of a host table on the un-pruned key plans (the
        float value lane the run store packs with): with its host-merged
        (N, T) ``perms``, Stage 1 only segments; without, it sorts on the
        device."""
        return mine_tuples(
            _as_tensor(rows, torch.int32, self.device), self._lo, self._hi,
            values=(None if vals is None
                    else _as_tensor(vals, torch.float32, self.device)),
            delta=self.delta, theta=self.theta, minsup=self.minsup,
            perms=(None if perms is None
                   else _as_tensor(perms, torch.int32, self.device)),
            packed=self.packed, sort_backend=self.sort_backend,
            use_kernels=self.use_kernels)

    def mine_windowed(self, chunks, values=None,
                      window_budget: Optional[int] = None,
                      stats: Optional[dict] = None,
                      probe=None) -> PipelineResult:
        """Fully windowed out-of-core mining: the host run sort of
        :meth:`mine_chunked` *and* a device pipeline that streams Stage
        1–3 through ``window_budget``-row slices of the merged sorted
        order (``core.windowed``), so peak incremental device memory is
        O(window), not O(T).  The sort chunking and the device window
        loop share the one budget (``radix.plan_windows``); ``None``
        takes the miner's ``window_budget``, and a single in-core window
        when that is None too.  Bit-identical to the in-core
        ``__call__`` on the same table; the leaves come back as host
        tensors.  ``probe`` is ``core.windowed``'s memory hook.

        Raises for configurations the windowed path cannot honour
        bit-exactly (keys wider than 64 bits, the forced-lexsort
        baseline) and for degenerate budgets — never a silent seam
        split."""
        if window_budget is None:
            window_budget = self.window_budget
        if not self.key_plans[0].fits:
            raise ValueError(
                "mine_windowed needs 64-bit-packable keys; this "
                "context's key exceeds 64 bits — use mine_chunked")
        if self.resolved_sort_backend == "lexsort":
            raise ValueError(
                "mine_windowed has no lexsort path (packed=False / "
                "sort_backend='lexsort'); use the monolithic pipeline "
                "for the lexsort baseline")
        if window_budget is not None and int(window_budget) < 1:
            raise ValueError(
                f"window_budget must be >= 1, got {window_budget}; "
                "pass None for a single in-core window")
        obs = _active_obs(self.obs)
        t0 = time.perf_counter() if obs is not None else 0.0
        store = self._sorted_store(chunks, values, window_budget, stats)
        if obs is not None:
            obs.metrics.histogram(
                "pipeline_stage_ms", stage="stage1_sort").observe(
                    (time.perf_counter() - t0) * 1e3)
        rows, vals = store.table()
        return self._mine_windows(rows, vals, store.perms(), window_budget,
                                  probe, obs)

    def _mine_windows(self, rows, vals, perms, window_budget,
                      probe=None, obs=None) -> PipelineResult:
        """``core.windowed.mine_windowed`` with this miner's settings."""
        from . import windowed as WD
        return WD.mine_windowed(
            rows, vals, perms, plans=self.key_plans, hash_lo=self._lo,
            hash_hi=self._hi, delta=self.delta, theta=self.theta,
            minsup=self.minsup, window_budget=window_budget,
            sort_backend=self.resolved_sort_backend,
            use_kernels=self.use_kernels, device=self.device, probe=probe,
            obs=obs)
