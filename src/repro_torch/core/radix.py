"""Bit-plan-pruned LSD radix sort: the default backend of
``keys.sort_with_payload``.  Port of ``repro.core.radix``.

The packed keys of ``core.keys`` are fixed-width words whose *live* bit
count is known from the bit-width plans, so only 8-bit digits that
overlap live bits get a pass: a 44-bit BibSonomy key is six passes, a
31-bit rank-coded MovieLens NOAC key four, a Stage-3 signature pair
eight.

The port runs the **histogram formulation** everywhere: one sweep builds
the 256-bucket histogram of every pass (``kernels.ops.radix_histogram``),
then each pass ranks its elements stably as ``bucket_start[digit] +
running occurrence`` and moves the key words and the permutation to
their ranks, in one fused op (``kernels.ops.radix_pass``) that reads the
words in the previous pass's order.  On CUDA tensors both ops launch the
hand-written kernels of ``kernels/csrc/radix_sort.cu``; on CPU tensors
their plain versions run.  (The JAX package's composite-word
formulation, which exists for XLA-CPU's slow variadic sort, is not
ported.)  The result is the stable sort permutation, equal to
``torch.sort(stable=True)`` of the words' order key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .bits import srl

#: Digit width of the histogram formulation.
HIST_DIGIT_BITS = 8
HIST_BUCKETS = 1 << HIST_DIGIT_BITS

#: Valid values of the ``sort_backend`` selector threaded through the
#: engines.  ``None``/'auto' resolve to 'radix' for fitting keys.
SORT_BACKENDS = ("radix", "lax", "lexsort")


def pos_bits(t: int) -> int:
    """Bits needed to embed positions 0..t-1 in a composite word."""
    return max(1, int(np.ceil(np.log2(max(int(t), 2)))))


@dataclasses.dataclass(frozen=True)
class RadixPlan:
    """Static pass schedule for sorting ``live_bits``-wide keys of a
    length-``t`` array: ``shifts[p]``/``widths[p]`` give pass p's digit
    as a bit range of the conceptual ≤64-bit key (LSB first)."""
    t: int
    live_bits: int
    pos_bits: int
    shifts: Tuple[int, ...]
    widths: Tuple[int, ...]

    @property
    def passes(self) -> int:
        return len(self.shifts)


def plan_radix(live_bits: int, t: int,
               digit_bits: Optional[int] = None) -> RadixPlan:
    """Pass schedule covering exactly the live bits (bit-plan pruning):
    ``ceil(live_bits / digit_bits)`` passes, digit width defaulting to
    the composite-word maximum ``32 - pos_bits(t)``."""
    live_bits = max(1, int(live_bits))
    pb = pos_bits(t)
    w = int(digit_bits) if digit_bits else 32 - pb
    if not 0 < w < 32:
        raise ValueError(f"digit width {w} out of range")
    shifts, widths, s = [], [], 0
    while s < live_bits:
        shifts.append(s)
        widths.append(min(w, live_bits - s))
        s += w
    return RadixPlan(int(t), live_bits, pb, tuple(shifts), tuple(widths))


def extract_digit(words: Sequence[torch.Tensor], shift: int,
                  width: int) -> torch.Tensor:
    """Bits [shift, shift+width) of msb-first packed words (int32 bit
    patterns), as a non-negative int32 digit.  ``width`` < 32."""
    mask = (1 << width) - 1
    if len(words) == 1:
        return srl(words[0], shift) & mask
    hi, lo = words
    if shift >= 32:
        return srl(hi, shift - 32) & mask
    if shift + width <= 32:
        return srl(lo, shift) & mask
    return (srl(lo, shift) | (hi << (32 - shift))) & mask


# ---------------------------------------------------------------------------
# Device sort
# ---------------------------------------------------------------------------

def _sort_histogram(words, live_bits: int, use_kernels: Optional[bool],
                    max_passes: Optional[int] = None
                    ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """(words in the sorted order, int32 stable sort permutation) via
    histogram ranks over the 8-bit digit schedule of ``live_bits``
    (truncated to ``max_passes``): one histogram sweep, then one fused
    pass (``kernels.ops.radix_pass``) per digit, which reads the words in
    the previous pass's order and moves them and the permutation to their
    ranks."""
    from ..kernels import ops as kops
    plan = plan_radix(live_bits, words[0].shape[0],
                      digit_bits=HIST_DIGIT_BITS)
    if max_passes is not None:
        plan = dataclasses.replace(plan, shifts=plan.shifts[:max_passes],
                                   widths=plan.widths[:max_passes])
    if plan.t == 0 or plan.passes == 0:
        return tuple(words), torch.arange(plan.t, dtype=torch.int32,
                                          device=words[0].device)
    hists = kops.radix_histogram(words, plan.shifts, plan.widths,
                                 use_kernels=use_kernels)
    starts_all = torch.cumsum(hists, dim=1, dtype=torch.int32) - hists
    cur, perm = tuple(words), None
    for p, (shift, width) in enumerate(zip(plan.shifts, plan.widths)):
        cur, perm = kops.radix_pass(cur, perm, shift, width, starts_all[p],
                                    use_kernels=use_kernels)
    return cur, perm


def radix_sort_perm(words: Sequence[torch.Tensor], live_bits: int,
                    use_kernels: Optional[bool] = None,
                    max_passes: Optional[int] = None) -> torch.Tensor:
    """int32 permutation stably sorting msb-first packed ``words``
    ascending (as unsigned).

    ``max_passes`` truncates the LSD schedule of 8-bit digits (per-pass
    attribution only — a truncated sort is *not* a total order)."""
    return _sort_histogram(words, live_bits, use_kernels, max_passes)[1]


def sort_with_payload_radix(words: Sequence[torch.Tensor],
                            payloads: Sequence[torch.Tensor],
                            live_bits: int,
                            use_kernels: Optional[bool] = None):
    """Drop-in for ``keys.sort_with_payload``: same (sorted_words,
    sorted_payloads) tuples, stability included.  The sorted words come
    out of the last pass; the payloads are gathered by the permutation."""
    s_words, perm = _sort_histogram(words, live_bits, use_kernels)
    return s_words, tuple(p[perm] for p in payloads)


# ---------------------------------------------------------------------------
# Host sort (streaming chunk runs)
# ---------------------------------------------------------------------------

def radix_argsort_host(keys: np.ndarray, live_bits: int) -> np.ndarray:
    """Stable ascending argsort of uint64 packed keys, LSD over 16-bit
    digits — numpy's stable sort is a radix sort for ≤16-bit integers,
    so each pass rides that fast path instead of a 64-bit mergesort.
    Bit-identical to ``np.argsort(keys, kind='stable')``."""
    keys = np.ascontiguousarray(keys, np.uint64)
    order = np.arange(keys.shape[0], dtype=np.int64)
    cur = keys
    shift = 0
    live_bits = max(1, int(live_bits))
    while shift < live_bits:
        w = min(16, live_bits - shift)
        dig = ((cur >> np.uint64(shift))
               & np.uint64((1 << w) - 1)).astype(np.uint16)
        o = np.argsort(dig, kind="stable")
        order = order[o]
        cur = cur[o]
        shift += w
    return order


# ---------------------------------------------------------------------------
# Window plan (shared sort/reduce streaming unit)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Static schedule of contiguous ``[start, stop)`` slices covering a
    length-``t`` sorted order in ``budget``-row windows: the streaming
    unit of the out-of-core path (a later slice of the port)."""
    t: int
    budget: int

    @property
    def n_windows(self) -> int:
        return -(-self.t // self.budget)

    @property
    def bounds(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((lo, min(lo + self.budget, self.t))
                     for lo in range(0, self.t, self.budget))


def plan_windows(t: int, budget: Optional[int] = None) -> WindowPlan:
    """Build the shared window plan.  ``budget=None`` (or >= t) is a
    single in-core window.  Degenerate budgets raise instead of being
    silently clamped."""
    t = int(t)
    if t < 1:
        raise ValueError(f"window plan needs a non-empty table, got t={t}")
    if budget is None:
        return WindowPlan(t, t)
    budget = int(budget)
    if budget < 1:
        raise ValueError(
            f"window_budget must be >= 1, got {budget}; pass None for a "
            "single in-core window")
    return WindowPlan(t, min(budget, t))


# ---------------------------------------------------------------------------
# Backend resolution (single source of truth for every engine)
# ---------------------------------------------------------------------------

def resolve_sort_backend(sort_backend: Optional[str],
                         packed: Optional[bool], fits: bool) -> str:
    """Map the user-facing (sort_backend, packed) pair onto the actual
    Stage-1/3 sort path: 'radix' (default for fitting keys), 'lax' (the
    packed comparison-sort baseline) or 'lexsort' (column fallback —
    forced, or required because the key exceeds 64 bits)."""
    if sort_backend not in (None, "auto") + SORT_BACKENDS:
        raise ValueError(
            f"sort_backend={sort_backend!r}; valid: {SORT_BACKENDS}")
    if sort_backend == "lexsort" or packed is False or not fits:
        return "lexsort"
    if sort_backend in (None, "auto"):
        return "radix"
    return sort_backend


def wants_value_pruning(prune_values, packed, sort_backend) -> bool:
    """Single definition of "should this engine compute the lane-pruning
    value domain?" — pruning is off only when disabled or when the
    caller forced the lexsort path.  Deliberately independent of the
    un-pruned ``fits``: a key that overflows 64 bits only because of
    the 32-bit float lane packs fine once pruned, so the sort path is
    re-resolved from the pruned plans afterwards."""
    return (bool(prune_values) and packed is not False
            and sort_backend != "lexsort")
