"""Frozen arithmetic of the metrics: percentiles over all requests and
intervals on one timeline."""
from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[int, int]


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value that at
    least ``q`` percent of ``values`` do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def quarter_means(values: Sequence[float]) -> List[float]:
    """Means of the four quarters of ``values`` in order (a quarter with
    no values left out)."""
    n = len(values)
    parts = [values[k * n // 4:(k + 1) * n // 4] for k in range(4)]
    return [sum(p) / len(p) for p in parts if p]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """Disjoint, sorted union of half-open ``[start, end)`` intervals
    (empty ones dropped)."""
    out: List[Interval] = []
    for start, end in sorted(i for i in intervals if i[1] > i[0]):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


def clip(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of ``intervals`` inside ``[lo, hi)``."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def covered(intervals: Iterable[Interval]) -> int:
    """Length of the union of ``intervals``."""
    return sum(e - s for s, e in merge(intervals))


def gaps(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of ``[lo, hi)`` that no interval covers."""
    out, at = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
