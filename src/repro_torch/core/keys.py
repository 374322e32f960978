"""Packed-key sorting: the one Stage-1/Stage-3 sort path of every engine.

Port of ``repro.core.keys``.  Each mode's lexicographic key — (other
columns..., [value-lane,] e_k) — is laid out as bit-fields of one
conceptual uint64 (``plan_mode_key``/``plan_context_keys``, plain Python
copied as is), packed on the host as ``np.uint64`` (``pack_host``) and
on the device as one or two msb-first uint32 words (``pack_device``),
which the port holds as ``int32`` bit patterns (``core.bits``).
``(hi << 32) | lo`` of the device words equals ``pack_host`` bit for bit.

The value lane is either the 32-bit order-preserving float encoding
(``float_sort_bits``) or, when the caller knows the distinct-value domain,
the value's rank in it (``value_slots``): an order-isomorphic code whose
width is ``ceil(log2 n_distinct)``.

``sort_with_payload`` sorts by the packed words: the radix backend of
``core.radix`` by default, or one stable ``torch.sort`` of the words'
``int64`` order key (``backend='lax'``).  Contexts whose key exceeds 64
bits report ``fits=False`` and the pipeline takes the column lexsort.

Value columns must be finite; the float lane distinguishes -0.0 from +0.0
and the rank lane does not (like the column lexsort).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .bits import SIGN, i32, srl, word_key

#: ``Field.src`` sentinel for the float-value lane of many-valued keys.
VALUE = -1

_SIGN = 0x80000000
_FULL = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Order-preserving float32 encoding (host + device, bit-identical)
# ---------------------------------------------------------------------------

def float_sort_bits_host(v: np.ndarray) -> np.ndarray:
    """Order-preserving uint32 encoding of finite float32 values."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return u ^ np.where(u & _SIGN, np.uint32(_FULL), np.uint32(_SIGN))


def float_sort_bits(v: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`float_sort_bits_host` (int32 bit patterns):
    negative floats flip every bit, the others only the sign bit."""
    u = v.to(torch.float32).contiguous().view(torch.int32)
    return u ^ torch.where(u < 0, -1, SIGN).to(torch.int32)


def float_from_sort_bits(u: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`float_sort_bits` (the encoding is a bijection)."""
    orig = u ^ torch.where(u < 0, SIGN, -1).to(torch.int32)
    return orig.contiguous().view(torch.float32)


# ---------------------------------------------------------------------------
# Bit-width planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Field:
    """One bit-field of a packed key: tuple column ``src`` (or ``VALUE``)
    at ``offset`` bits from the LSB, ``width`` bits wide."""
    src: int
    offset: int
    width: int


def entity_bits(size: int) -> int:
    """Bits needed for ids 0..size-1 (≥ 1, matching the streaming codec)."""
    return max(1, int(np.ceil(np.log2(max(int(size), 2)))))


def value_lane_bits(value_slots: Optional[int]) -> int:
    """Width of the value lane: rank bits for a known ``value_slots``-sized
    domain, the full float32 sort-bit encoding otherwise."""
    return 32 if value_slots is None else entity_bits(value_slots)


def value_domain_host(values) -> np.ndarray:
    """Sorted distinct float32 values — THE lane-pruning domain (one
    definition, so host packers and engines can never disagree on
    dedup/ordering semantics, e.g. -0.0 == +0.0)."""
    return np.unique(np.asarray(values, np.float32))


@dataclasses.dataclass(frozen=True)
class ModeKeyPlan:
    """Bit layout of mode ``k``'s sort key (msb-first ``fields``)."""
    k: int
    sizes: Tuple[int, ...]
    with_values: bool
    fields: Tuple[Field, ...]
    total_bits: int
    e_bits: int          # width of the trailing e_k field
    seg_shift: int       # bits to drop to recover the subrelation key
    fits: bool           # total_bits <= 64: packed path available
    value_bits: int = 32  # value-lane width (< 32: rank-coded, needs domain)

    @property
    def words(self) -> int:
        """Device words (uint32) holding the key: 1 or 2."""
        return 1 if self.total_bits <= 32 else 2

    @property
    def e_mask(self) -> int:
        return (1 << self.e_bits) - 1

    # -- value-lane encoding ------------------------------------------------

    def value_lane_host(self, values: np.ndarray,
                        domain: Optional[np.ndarray] = None) -> np.ndarray:
        """uint32 lane codes for float32 ``values``: sort bits, or ranks
        in the sorted distinct-value ``domain`` (pruned plans)."""
        if self.value_bits == 32:
            return float_sort_bits_host(values)
        if domain is None:
            raise ValueError("rank-coded value lane needs the domain")
        return np.searchsorted(np.asarray(domain, np.float32),
                               np.asarray(values, np.float32),
                               side="left").astype(np.uint32)

    def value_lane(self, values: torch.Tensor,
                   domain: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Device twin of :meth:`value_lane_host` (int32 bit patterns)."""
        if self.value_bits == 32:
            return float_sort_bits(values)
        if domain is None:
            raise ValueError("rank-coded value lane needs the domain")
        return torch.searchsorted(domain.to(torch.float32).contiguous(),
                                  values.to(torch.float32).contiguous(),
                                  side="left").to(torch.int32)

    # -- packing ------------------------------------------------------------

    def pack_host(self, rows: np.ndarray,
                  values: Optional[np.ndarray] = None,
                  domain: Optional[np.ndarray] = None) -> np.ndarray:
        """(L, N) int32 rows [+ (L,) float32 values] -> (L,) uint64 keys."""
        key = np.zeros(rows.shape[0], np.uint64)
        lane = (self.value_lane_host(values, domain)
                if self.with_values else None)
        for f in self.fields:
            v = lane if f.src == VALUE else rows[:, f.src].astype(np.uint32)
            key = (key << np.uint64(f.width)) | v.astype(np.uint64)
        return key

    def pack_device(self, tuples: torch.Tensor,
                    values: Optional[torch.Tensor] = None,
                    domain: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ...]:
        """Device packing: msb-first int32 words ((hi, lo) or (lo,)).

        ``(hi << 32) | lo`` (as uint32) equals :meth:`pack_host` bit for
        bit; a field that straddles the words puts its high bits in ``hi``
        through a logical shift."""
        t = tuples.shape[0]
        lo = torch.zeros((t,), dtype=torch.int32, device=tuples.device)
        hi = torch.zeros_like(lo)
        lane = self.value_lane(values, domain) if self.with_values else None
        for f in self.fields:
            v = lane if f.src == VALUE else tuples[:, f.src].to(torch.int32)
            if f.offset < 32:
                lo = lo | (v << f.offset if f.offset else v)
                if f.offset + f.width > 32:
                    hi = hi | srl(v, 32 - f.offset)
            else:
                hi = hi | (v << (f.offset - 32) if f.offset > 32 else v)
        return (hi, lo) if self.words == 2 else (lo,)

    def extract_entity(self, words: Sequence[torch.Tensor]) -> torch.Tensor:
        """Recover the e_k column from packed words (e_k is the LSB field)."""
        return words[-1] & self.e_mask

    def extract_values(self, words: Sequence[torch.Tensor],
                       domain: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """Recover the float32 value column from packed words (many-valued
        plans only; the value lane sits at bit offset ``e_bits``): sort
        bits invert bijectively, rank lanes gather from the domain."""
        if not self.with_values:
            raise ValueError("plan has no value lane")
        if self.value_bits == 32:
            s = self.e_bits                 # 1 <= s <= 31, value needs 2 words
            u = srl(words[-1], s) | (words[-2] << (32 - s))
            return float_from_sort_bits(u)
        if domain is None:
            raise ValueError("rank-coded value lane needs the domain")
        from .radix import extract_digit
        rank = extract_digit(words, self.e_bits, self.value_bits)
        return domain.to(torch.float32)[rank]

    def delta_query_words(self, words: Sequence[torch.Tensor],
                          lane: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Each key's words with the value lane replaced by ``lane`` (codes
        of :meth:`value_lane`'s encoding) and e_k zeroed — the δ-window
        *lower-bound* query key (OR ``e_mask`` onto the last word for the
        upper bound).  Because the subrelation prefix leads the key, a
        global search with these queries self-clamps to the tuple's own
        segment."""
        if not self.with_values:
            raise ValueError("plan has no value lane")
        eb, ss = self.e_bits, self.seg_shift
        part_lo = lane << eb                # int32 keeps the low word
        part_hi = srl(lane, 32 - eb)        # 0 unless the lane spans words
        if len(words) == 1:
            return ((words[0] & i32(~((1 << ss) - 1))) | part_lo,)
        hi, lo = words
        if ss >= 32:                        # value+e tail fills the low word
            return ((hi & i32(~((1 << (ss - 32)) - 1))) | part_hi, part_lo)
        return (hi, (lo & i32(~((1 << ss) - 1))) | part_lo)


def plan_mode_key(sizes: Sequence[int], k: int, with_values: bool,
                  value_slots: Optional[int] = None) -> ModeKeyPlan:
    """Lay out mode ``k``'s sort key (others..., [value,] e_k) msb-first.

    ``value_slots`` — the context's distinct-value count, when known —
    prunes the value lane to rank width (see module docstring)."""
    sizes = tuple(int(s) for s in sizes)
    bits = [entity_bits(s) for s in sizes]
    vb = value_lane_bits(value_slots)
    order = [j for j in range(len(sizes)) if j != k]
    order += ([VALUE] if with_values else []) + [k]
    widths = [vb if j == VALUE else bits[j] for j in order]
    total = sum(widths)
    fields, off = [], total
    for src, w in zip(order, widths):
        off -= w
        fields.append(Field(src, off, w))
    return ModeKeyPlan(
        k=k, sizes=sizes, with_values=with_values, fields=tuple(fields),
        total_bits=total, e_bits=bits[k],
        seg_shift=bits[k] + (vb if with_values else 0), fits=total <= 64,
        value_bits=vb)


def plan_context_keys(sizes: Sequence[int], with_values: bool,
                      value_slots: Optional[int] = None
                      ) -> Tuple[ModeKeyPlan, ...]:
    """One plan per mode.  All plans share ``total_bits``/``fits`` (every
    mode's key covers all columns), so ``plans[0].fits`` decides the
    context's sort path."""
    return tuple(plan_mode_key(sizes, k, with_values, value_slots)
                 for k in range(len(sizes)))


# ---------------------------------------------------------------------------
# Device-side sorting primitives
# ---------------------------------------------------------------------------

def drop_low_bits(words: Tuple[torch.Tensor, ...],
                  shift: int) -> Tuple[torch.Tensor, ...]:
    """Words representing ``key >> shift`` (msb-first; order-preserving),
    used to compare subrelation keys without re-materialising columns."""
    if shift == 0:
        return words
    if len(words) == 1:
        return (srl(words[0], shift),)
    hi, lo = words
    if shift == 32:
        return (hi,)
    if shift > 32:
        return (srl(hi, shift - 32),)
    return (hi, srl(lo, shift))


def sort_with_payload(words: Sequence[torch.Tensor],
                      payloads: Sequence[torch.Tensor],
                      backend: str = "radix",
                      live_bits: Optional[int] = None,
                      use_kernels: Optional[bool] = None):
    """Stable sort keyed on the packed words with payload columns
    carried along.  The default backend is the bit-plan-pruned LSD radix
    of ``core.radix`` (``live_bits`` prunes the pass schedule to the
    key's live bit count).  ``backend='lax'`` is one stable
    ``torch.sort`` of the words' int64 order key.  Both give the same
    permutation.  Returns (sorted_words, sorted_payloads), both tuples."""
    if backend == "radix":
        from . import radix as RX
        return RX.sort_with_payload_radix(
            words, payloads, live_bits or 32 * len(words), use_kernels)
    _, perm = torch.sort(word_key(words), stable=True)
    return (tuple(w[perm] for w in words),
            tuple(p[perm] for p in payloads))


def search_words(s_words: Sequence[torch.Tensor],
                 q_words: Sequence[torch.Tensor],
                 upper: bool) -> torch.Tensor:
    """Binary search over sorted packed keys.  Returns, per query, the
    first index whose key is > the query (``upper``) or >= it (lower
    bound); T if none.  Keys compare as unsigned msb-first word tuples."""
    return torch.searchsorted(word_key(s_words), word_key(q_words),
                              right=upper).to(torch.int32)
