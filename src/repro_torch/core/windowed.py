"""Windowed device pipeline: Stage 1–3 through bounded device key
windows.  Port of ``repro.core.windowed``.

The monolithic ``pipeline.mine_tuples`` materialises every Stage-1/2/3
intermediate at full table length T on the device, so one card can only
mine tables that fit in its memory.  This module streams the *same*
three stages through ``window_budget``-row slices of the merged sorted
order (the ``RunStore`` per-mode host permutations are the window
iterator), carrying the open segment's seam state across windows, and
gives the monolithic path's result leaf for leaf, bit for bit:

* **Stage 1** — per mode, the device scans each window of the sorted
  packed key words through the fused segment reduction
  (``kernels.ops.segment_reduce``, the ``segment_reduce`` kernel on
  CUDA, as ``pipeline.masked_prefix`` runs it).  The seam carry is
  three 0-d int32 tensors on the device — the running masked prefix
  sums (hash lanes lo/hi, distinct counter), wrapping mod 2³² like
  every hash lane of the port (``core.bits``) — plus the previous
  window's last key, read on the host: adding the carried last
  inclusive value to the next window's local scan reproduces the global
  prefix sums exactly, however many windows one key segment (or NOAC
  δ-window) spans.  The host assembles the exclusive (T+1) prefix
  arrays and derives segment bounds and δ-window bounds from the sorted
  uint64 keys it already holds (``pack_host`` equals ``pack_device``
  bit for bit, and ``np.searchsorted`` over the packed keys is
  ``keys.search_words``).

* **Stage 2** — the signature mix and the volume product are
  elementwise, so they run as window-sized device maps over the
  original tuple order, through ``pipeline.mix_signatures`` itself.

* **Stage 3** — each original-order window is sorted on the packed
  2×32-bit cluster signature on the device (``keys.sort_with_payload``,
  64 live bits: the ``radix_histogram`` and ``radix_rank`` kernels on
  CUDA), then a host k-way combine merges the per-window runs on the
  packed signature word — the two-searchsorted stable merge of
  ``runs.merge_runs``, earlier windows on the a-side, so the combined
  order is the monolithic stable sort's (signature, original position)
  order.  Group statistics are the monolithic prefix-difference
  formulas on the combined order.

The JAX package pads the tail window to the full budget so that its
jitted bodies trace once; PyTorch runs eagerly, so the tail window runs
at its own length here (pads contribute nothing either way).

Memory model: the device holds O(window) stage buffers plus the O(n_k)
hash vectors; the host holds the O(T) table, sorted keys and result
arrays, which it holds anyway (the table comes from the host run store,
and results are read on the host).  Peak *incremental* device memory
is O(window), not O(T) (``core.memprobe`` measures it).

Results are **host tensors** (CPU, over the numpy arrays the host
assembled) inside the usual ``PipelineResult``: shipping the O(T)
result back to the device would bring back the O(T) footprint the
windows avoid.  Their dtypes are the in-core result's (int32 bit
patterns for the signatures).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops as kops
from . import keys as K
from . import pipeline as P
from . import radix as RX

#: Stage names reported through the ``probe`` callback (one call per
#: device window, after its copy back to the host).
STAGES = ("stage1_scan", "stage2_mix", "stage3_sort")

_U64_FULL = 0xFFFFFFFFFFFFFFFF


# ---------------------------------------------------------------------------
# Device window bodies
# ---------------------------------------------------------------------------

def _scan_window(words, first0: bool, carry, r_lo, r_hi, e_mask: int,
                 use_kernels: Optional[bool]):
    """Stage-1 window body: first-occurrence flags from the key words
    (seam-aware via ``first0``), the fused masked segment reduction, and
    the carry.  Returns the window's inclusive global prefix sums; their
    last elements are the next window's carry."""
    first = torch.empty(words[0].shape, dtype=torch.bool,
                        device=words[0].device)
    torch.ne(words[0][1:], words[0][:-1], out=first[1:])
    for w in words[1:]:
        first[1:] |= w[1:] != w[:-1]
    first[:1].fill_(first0)
    e = words[-1] & e_mask
    sums = kops.segment_reduce(r_lo[e], r_hi[e], first,
                               use_kernels=use_kernels)
    for s, c in zip(sums, carry):
        s += c
    return sums


def _mix_window(slo: torch.Tensor, shi: torch.Tensor, card: torch.Tensor):
    """Stage-2 window body: ``pipeline.mix_signatures`` and the volume
    product over (N, B) per-mode stacks."""
    n = slo.shape[0]
    lo, hi = P.mix_signatures([slo[k] for k in range(n)],
                              [shi[k] for k in range(n)])
    vol = torch.ones(slo.shape[1:], dtype=torch.float32, device=slo.device)
    for k in range(n):
        vol = vol * card[k].to(torch.float32)
    return lo, hi, vol


def _sort_window(sig_lo: torch.Tensor, sig_hi: torch.Tensor, backend: str,
                 use_kernels: Optional[bool]):
    """Stage-3 window body: one stable device sort of the window's packed
    signatures with an iota payload (the monolithic Stage-3 sort at
    window size)."""
    iota = torch.arange(sig_lo.shape[0], dtype=torch.int32,
                        device=sig_lo.device)
    (s_lo, s_hi), (idx,) = K.sort_with_payload(
        (sig_lo, sig_hi), (iota,), backend=backend, live_bits=64,
        use_kernels=use_kernels)
    return s_lo, s_hi, idx


# ---------------------------------------------------------------------------
# Host helpers (numpy mirrors of the pipeline's segment primitives)
# ---------------------------------------------------------------------------

def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _to_dev(a: np.ndarray, device) -> torch.Tensor:
    """A host uint32/int32 array as a device int32 (bit-pattern) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
        device)


def _split_words(keys_u64: np.ndarray, nwords: int) -> Tuple[np.ndarray, ...]:
    """Host uint64 keys -> the device's msb-first uint32 word tuple."""
    lo = (keys_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if nwords == 1:
        return (lo,)
    return ((keys_u64 >> np.uint64(32)).astype(np.uint32), lo)


def _diff_flags(sorted_keys: np.ndarray) -> np.ndarray:
    """Host ``segment_starts`` over one sorted uint64 key column."""
    f = np.empty(sorted_keys.shape[0], bool)
    f[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=f[1:])
    return f


def _seg_bounds(flags: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host ``pipeline.segment_bounds``: forward cummax / reverse
    cummin over start flags -> per-position [a, b) segment windows."""
    t = flags.shape[0]
    pos = np.arange(t, dtype=np.int32)
    a = np.maximum.accumulate(np.where(flags, pos, 0)).astype(np.int32)
    suff = np.minimum.accumulate(
        np.where(flags, pos, np.int32(t))[::-1])[::-1]
    b = np.concatenate([suff[1:], np.full(1, t, np.int32)]).astype(np.int32)
    return a, b


def _scatter(perm: np.ndarray, sorted_arr: np.ndarray) -> np.ndarray:
    """Sorted-order array -> original tuple order (the inverse-perm
    gather of the monolithic path, as one scatter)."""
    out = np.empty(sorted_arr.shape[0], sorted_arr.dtype)
    out[perm] = sorted_arr
    return out


def _merge_pair(a, b):
    """Stable two-searchsorted merge of two (sig_word, orig_idx) runs,
    a-side winning ties — ``runs.merge_runs`` on signature words."""
    ka, ia = a
    kb, ib = b
    if ka.size == 0:
        return b
    if kb.size == 0:
        return a
    if ka[-1] <= kb[0]:
        return np.concatenate([ka, kb]), np.concatenate([ia, ib])
    if kb[-1] < ka[0]:
        return np.concatenate([kb, ka]), np.concatenate([ib, ia])
    pa = np.searchsorted(kb, ka, side="left") + np.arange(ka.size)
    pb = np.searchsorted(ka, kb, side="right") + np.arange(kb.size)
    mk = np.empty(ka.size + kb.size, np.uint64)
    mi = np.empty(ka.size + kb.size, np.int64)
    mk[pa] = ka
    mk[pb] = kb
    mi[pa] = ia
    mi[pb] = ib
    return mk, mi


def _kway_combine(parts):
    """Balanced k-way combine of per-window signature runs.  Adjacent
    pairs merge with the left (earlier windows, smaller original
    indices) on the a-side, so ties resolve to ascending original
    position — the stable global Stage-3 order."""
    parts = list(parts)
    while len(parts) > 1:
        parts = [parts[i] if i + 1 == len(parts)
                 else _merge_pair(parts[i], parts[i + 1])
                 for i in range(0, len(parts), 2)]
    return parts[0]


# ---------------------------------------------------------------------------
# The windowed driver
# ---------------------------------------------------------------------------

def mine_windowed(rows, values, perms, *,
                  plans: Sequence[K.ModeKeyPlan],
                  hash_lo: Sequence[torch.Tensor],
                  hash_hi: Sequence[torch.Tensor],
                  delta: Optional[float] = None, theta: float = 0.0,
                  minsup: int = 0,
                  window_budget: Optional[int] = None,
                  sort_backend: str = "radix",
                  use_kernels: Optional[bool] = None,
                  device=None,
                  probe: Optional[Callable[[str], None]] = None
                  ) -> P.PipelineResult:
    """Mine ``rows`` through bounded device windows; bit-identical to
    ``pipeline.mine_tuples`` on the same table (every ``PipelineResult``
    leaf, permutations included).

    ``rows``/``values`` is the host table, ``perms`` the (N, T) merged
    per-mode sort permutations (``RunStore.perms``).  ``plans`` must be
    the *un-pruned* context key plans (float value lane — the plans the
    run store packed with); ``hash_lo``/``hash_hi`` the per-mode int32
    hash lanes (``pipeline.hash_vectors_from_numpy``).
    ``window_budget=None`` runs a single in-core window through the same
    code.  ``device`` (default CUDA) runs the windows; ``use_kernels`` as
    in ``kernels.ops`` (None: the kernels on CUDA).

    ``probe`` (optional) is called with a :data:`STAGES` name after each
    device window's result is back on the host — the peak-memory hook
    (``core.memprobe.MemProbe``).

    Raises ``ValueError`` for degenerate budgets (< 1) and for
    configurations the windowed path cannot honour bit-exactly (keys
    wider than 64 bits, the lexsort baseline, rank-coded value lanes)
    instead of silently widening or splitting.
    """
    if not plans[0].fits:
        raise ValueError(
            "windowed mining needs 64-bit-packable keys (plans[0].fits); "
            "this context's key exceeds 64 bits — use mine_chunked or the "
            "monolithic lexsort path instead")
    if sort_backend not in ("radix", "lax"):
        raise ValueError(
            f"windowed mining supports sort_backend 'radix' or 'lax', got "
            f"{sort_backend!r}; the lexsort baseline has no packed host "
            "keys to window over")
    dev = resolve_device(device)
    rows = np.asarray(rows, np.int32)
    t, n = rows.shape
    if delta is not None:
        if delta < 0:
            raise ValueError(f"delta must be >= 0, got {delta}")
        if values is None:
            values = np.zeros((t,), np.float32)
        values = np.asarray(values, np.float32)
        if not plans[0].with_values or plans[0].value_bits != 32:
            raise ValueError(
                "windowed mining needs the un-pruned float value lane "
                "(plan_context_keys(..., value_slots=None))")
    else:
        values = None
    perms = np.asarray(perms)
    if perms.shape != (n, t):
        raise ValueError(f"perms shape {perms.shape} != {(n, t)}")
    bounds = RX.plan_windows(t, window_budget).bounds  # raises on budget < 1
    hash_lo = [h.to(dev) for h in hash_lo]
    hash_hi = [h.to(dev) for h in hash_hi]

    # ---- Stage 1: per-mode windowed masked-prefix scans + host bounds
    mode_sig_lo = np.empty((n, t), np.uint32)
    mode_sig_hi = np.empty((n, t), np.uint32)
    mode_card = np.empty((n, t), np.int32)
    mode_rlo = np.empty((n, t), np.int32)
    mode_rhi = np.empty((n, t), np.int32)
    sorted_e = np.empty((n, t), np.int32)
    tfirst = None
    for k in range(n):
        plan = plans[k]
        perm = perms[k].astype(np.int64)
        sk = plan.pack_host(rows, values)[perm]
        words_host = _split_words(sk, plan.words)
        pref = [np.zeros(t + 1, np.int32) for _ in range(3)]
        carry = [torch.zeros((), dtype=torch.int32, device=dev)
                 for _ in range(3)]
        for w0, w1 in bounds:
            words = tuple(_to_dev(w[w0:w1], dev) for w in words_host)
            first0 = bool(w0 == 0 or sk[w0] != sk[w0 - 1])
            sums = _scan_window(words, first0, carry, hash_lo[k],
                                hash_hi[k], plan.e_mask, use_kernels)
            carry = [s[-1] for s in sums]
            for p, s in zip(pref, sums):
                p[w0 + 1:w1 + 1] = _host(s)
            if probe is not None:
                probe("stage1_scan")
        pref_lo, pref_hi = pref[0].view(np.uint32), pref[1].view(np.uint32)
        pref_cnt = pref[2]
        # component windows in sorted order: whole key segment (prime)
        # or the δ-value range inside it (NOAC, global self-clamping
        # search — the host twin of keys.search_words)
        if delta is None:
            a, b = _seg_bounds(_diff_flags(sk >> np.uint64(plan.seg_shift)))
        else:
            d = np.float32(delta)
            s_vals = values[perm]
            t_lo = (s_vals - d).astype(np.float32)
            t_hi = (s_vals + d).astype(np.float32)
            t_lo = np.where(t_lo == 0, np.float32(0.0), t_lo)
            t_hi = np.where(t_hi == 0, np.float32(0.0), t_hi)
            lane_lo = K.float_sort_bits_host(t_lo).astype(np.uint64)
            lane_hi = K.float_sort_bits_host(t_hi).astype(np.uint64)
            base = sk & np.uint64(~((1 << plan.seg_shift) - 1) & _U64_FULL)
            eb = np.uint64(plan.e_bits)
            q_lo = base | (lane_lo << eb)
            q_hi = base | (lane_hi << eb) | np.uint64(plan.e_mask)
            a = np.searchsorted(sk, q_lo, side="left").astype(np.int32)
            b = np.searchsorted(sk, q_hi, side="right").astype(np.int32)
        bl, al = b.astype(np.int64), a.astype(np.int64)
        mode_sig_lo[k] = _scatter(perm, pref_lo[bl] - pref_lo[al])
        mode_sig_hi[k] = _scatter(perm, pref_hi[bl] - pref_hi[al])
        mode_card[k] = _scatter(perm, pref_cnt[bl] - pref_cnt[al])
        mode_rlo[k] = _scatter(perm, a)
        mode_rhi[k] = _scatter(perm, b)
        sorted_e[k] = rows[perm, k]
        if k == 0:
            # mode 0's key covers the whole row: its first-occurrence
            # flags mark the lowest-index copy of each duplicate row
            tfirst = _scatter(perm, _diff_flags(sk))

    # ---- Stage 2: elementwise mix/volume windows over original order
    sig_lo = np.empty(t, np.int32)
    sig_hi = np.empty(t, np.int32)
    volume = np.empty(t, np.float32)
    for w0, w1 in bounds:
        lo, hi, vol = _mix_window(_to_dev(mode_sig_lo[:, w0:w1], dev),
                                  _to_dev(mode_sig_hi[:, w0:w1], dev),
                                  _to_dev(mode_card[:, w0:w1], dev))
        sig_lo[w0:w1] = _host(lo)
        sig_hi[w0:w1] = _host(hi)
        volume[w0:w1] = _host(vol)
        if probe is not None:
            probe("stage2_mix")

    # ---- Stage 3: per-window device signature sorts + host combine
    parts = []
    for w0, w1 in bounds:
        s_lo, s_hi, idx = _sort_window(_to_dev(sig_lo[w0:w1], dev),
                                       _to_dev(sig_hi[w0:w1], dev),
                                       sort_backend, use_kernels)
        # the Stage-3 sort keys (sig_lo, sig_hi) msb-first — sig_lo is
        # the high word of the packed signature the combine merges on
        word = ((_host(s_lo).view(np.uint32).astype(np.uint64)
                 << np.uint64(32))
                | _host(s_hi).view(np.uint32).astype(np.uint64))
        parts.append((word, w0 + _host(idx).astype(np.int64)))
        if probe is not None:
            probe("stage3_sort")
    s_word, order = _kway_combine(parts)
    # group stats on the combined order — the monolithic stage3_dedup
    # prefix-difference formulas on the host
    s_first = tfirst[order]
    a3, b3 = _seg_bounds(_diff_flags(s_word))
    pref = np.concatenate([np.zeros(1, np.int32),
                           np.cumsum(s_first.astype(np.int32),
                                     dtype=np.int32)])
    pos = np.arange(t, dtype=np.int32)
    uniq_sorted = s_first & (pref[pos] == pref[a3])
    gen_sorted = pref[b3.astype(np.int64)] - pref[a3.astype(np.int64)]
    gen_count = np.empty(t, np.int32)
    gen_count[order] = gen_sorted
    is_unique = np.empty(t, bool)
    is_unique[order] = uniq_sorted

    density = gen_count.astype(np.float32) / np.maximum(volume,
                                                        np.float32(1.0))
    keep = is_unique & (density >= np.float32(theta))
    if minsup:
        for k in range(n):
            keep = keep & (mode_card[k] >= minsup)
    host = torch.from_numpy
    return P.PipelineResult(
        sig_lo=host(sig_lo), sig_hi=host(sig_hi),
        is_unique=host(is_unique), gen_count=host(gen_count),
        volume=host(volume), density=host(density), keep=host(keep),
        cardinalities=host(mode_card),
        range_lo=host(mode_rlo), range_hi=host(mode_rhi),
        sorted_e=host(sorted_e),
        perms=host(np.ascontiguousarray(perms, np.int32)))
