"""Process-local metrics registry (DESIGN.md §11).  A copy of
``repro.obs.metrics``: the same bucket math and exposition text.

One :class:`Registry` per process holds every instrument the serving
plane and the mining pipeline report into: **counters** (monotone),
**gauges** (set/add), and **log-bucketed histograms** whose quantiles
(p50/p99) are derived from geometric buckets with a bounded relative
error — ``bucket_ratio ** 0.5 - 1`` (≈ 4.4% at the default ratio of
``2 ** (1/8)``), tight enough to audit tail latency without keeping
raw samples.

Design constraints, in order:

1. **Hot-path cheapness.**  A histogram observation is one lock, one
   ``math.log`` and two integer adds; a counter bump is one lock and
   one add.  Instrument handles are cached by ``(name, labels)`` so
   steady-state callers never re-enter the registry dict.
2. **Zero overhead when disabled.**  A registry built with
   ``enabled=False`` (or the shared :data:`NULL`) hands every caller
   the same no-op instrument — the disabled path is attribute access
   plus one ``if``; nothing is allocated, counted or locked.  Code
   that wants even the attribute access gone holds ``None`` and guards
   with ``is None`` (the convention the mining pipeline uses).
3. **One source of truth.**  Components that already keep counter
   dicts (``TriclusterService._stats``, supervisor event tallies)
   register a *collector* — a callable returning ``(name, labels,
   value)`` rows rendered at scrape time — instead of double-writing.
   /stats keeps reading the dicts; /metrics renders them; nothing is
   stored twice.

Exposition is Prometheus text format 0.0.4 (``expose()``); the same
data is available structurally via ``to_dict()`` for /stats-style JSON
views and tests.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["Registry", "Counter", "Gauge", "Histogram", "NULL",
           "NullInstrument", "DEFAULT_BUCKET_RATIO"]

#: geometric bucket growth factor: 2 ** (1/8) keeps the worst-case
#: quantile relative error at sqrt(ratio) - 1 ≈ 4.4%
DEFAULT_BUCKET_RATIO = 2.0 ** 0.125
#: default bucket span: [lo, hi) in whatever unit the caller observes
#: (the serving plane observes milliseconds: 1 µs .. 100 s)
DEFAULT_LO = 1e-3
DEFAULT_HI = 1e5


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(items: Tuple[Tuple[str, str], ...]) -> str:
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in items) + "}"


class NullInstrument:
    """Shared no-op stand-in for every instrument kind on a disabled
    registry: all mutators do nothing, all readers answer zero."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def add(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    @property
    def sum(self) -> float:
        return 0.0

    def quantile(self, q: float) -> Optional[float]:
        return None

    def percentiles(self) -> dict:
        return {"p50": None, "p99": None}


_NULL_INSTRUMENT = NullInstrument()


class Counter:
    """Monotone counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Set/add instantaneous value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    inc = add

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Log-bucketed histogram: geometric bucket boundaries
    ``lo * ratio**i`` spanning ``[lo, hi)``, plus an underflow bucket
    (everything ``<= lo``, including zeros/negatives) and an overflow
    bucket (``>= hi``).  Tracks exact count/sum/min/max alongside the
    bucket counts, so :meth:`quantile` can clamp its bucket-midpoint
    estimate to the observed range — the p0/p100 ends are exact, the
    middle has relative error ≤ ``sqrt(ratio) - 1``."""

    __slots__ = ("_lock", "lo", "hi", "ratio", "_log_ratio", "_log_lo",
                 "_n_buckets", "_counts", "_count", "_sum", "_min",
                 "_max")

    def __init__(self, lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 ratio: float = DEFAULT_BUCKET_RATIO):
        if not (lo > 0 and hi > lo and ratio > 1.0):
            raise ValueError("need 0 < lo < hi and ratio > 1")
        self._lock = threading.Lock()
        self.lo, self.hi, self.ratio = float(lo), float(hi), float(ratio)
        self._log_ratio = math.log(self.ratio)
        self._log_lo = math.log(self.lo)
        # bucket i covers (lo * r**(i-1), lo * r**i]; bucket 0 is the
        # underflow (<= lo), the last is the overflow (> hi)
        self._n_buckets = int(math.ceil(
            (math.log(self.hi) - self._log_lo) / self._log_ratio)) + 2
        self._counts = [0] * self._n_buckets
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        if v >= self.hi:
            return self._n_buckets - 1
        i = int(math.ceil((math.log(v) - self._log_lo)
                          / self._log_ratio))
        return min(max(i, 1), self._n_buckets - 2)

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._index(v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _upper(self, i: int) -> float:
        """Upper bound of bucket ``i`` (inf for the overflow bucket)."""
        if i <= 0:
            return self.lo
        if i >= self._n_buckets - 1:
            return math.inf
        return self.lo * self.ratio ** i

    def _mid(self, i: int) -> float:
        """Representative value of bucket ``i``: geometric midpoint of
        its bounds (underflow → lo, overflow → observed max)."""
        if i <= 0:
            return self.lo
        if i >= self._n_buckets - 1:
            return self._max if self._max > 0 else self.hi
        hi = self.lo * self.ratio ** i
        return hi / math.sqrt(self.ratio)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-derived q-quantile (0 ≤ q ≤ 1), clamped to the exact
        observed [min, max]; None when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            n = self._count
            if n == 0:
                return None
            rank = q * (n - 1)
            acc = 0
            est = self._max
            for i, c in enumerate(self._counts):
                acc += c
                if acc > rank:
                    est = self._mid(i)
                    break
            return min(max(est, self._min), self._max)

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50), "p99": self.quantile(0.99)}

    def snapshot(self) -> dict:
        """Structural view: cumulative Prometheus-style buckets plus
        exact count/sum/min/max and derived p50/p99."""
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
            mn = None if count == 0 else self._min
            mx = None if count == 0 else self._max
        cum, buckets = 0, []
        for i, c in enumerate(counts):
            cum += c
            if c or i == len(counts) - 1:
                buckets.append((self._upper(i), cum))
        return {"count": count, "sum": total, "min": mn, "max": mx,
                "buckets": buckets,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99)}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """Thread-safe instrument registry with Prometheus text exposition.

    ``counter(name, **labels)`` / ``gauge(...)`` / ``histogram(...)``
    return (and memoise) the instrument for that ``(name, labels)``
    series.  A name is bound to one kind forever — asking for the same
    name as a different kind raises.  ``register_collector(fn)`` adds a
    scrape-time callable yielding ``(name, labels_dict, value)`` rows
    (rendered as gauges) — the bridge that folds existing stats dicts
    into /metrics without double-writing them.
    """

    def __init__(self, enabled: bool = True, namespace: str = "repro"):
        self.enabled = bool(enabled)
        self.namespace = str(namespace)
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}
        self._series: Dict[str, Dict[Tuple, object]] = {}
        self._collectors: List[Callable[[], Iterable[tuple]]] = []

    # -- instrument access ----------------------------------------------------

    def _get(self, kind: str, name: str, labels: dict, **kw):
        if not self.enabled:
            return _NULL_INSTRUMENT
        key = _label_key(labels)
        with self._lock:
            have = self._kinds.get(name)
            if have is None:
                self._kinds[name] = kind
                self._series[name] = {}
            elif have != kind:
                raise ValueError(f"metric {name!r} is a {have}, "
                                 f"not a {kind}")
            inst = self._series[name].get(key)
            if inst is None:
                inst = _KINDS[kind](**kw)
                self._series[name][key] = inst
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, lo: float = DEFAULT_LO,
                  hi: float = DEFAULT_HI,
                  ratio: float = DEFAULT_BUCKET_RATIO,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels, lo=lo, hi=hi,
                         ratio=ratio)

    def register_collector(self,
                           fn: Callable[[], Iterable[tuple]]) -> None:
        """``fn()`` yields ``(name, labels_dict, value)`` rows at scrape
        time; non-numeric values are skipped.  No-op when disabled."""
        if not self.enabled:
            return
        with self._lock:
            self._collectors.append(fn)

    # -- views ----------------------------------------------------------------

    def _items(self):
        with self._lock:
            return [(name, self._kinds[name], dict(series))
                    for name, series in sorted(self._series.items())]

    def _collected(self) -> List[tuple]:
        with self._lock:
            collectors = list(self._collectors)
        rows: List[tuple] = []
        for fn in collectors:
            try:
                for name, labels, value in fn():
                    if isinstance(value, bool):
                        value = int(value)
                    if not isinstance(value, (int, float)) or \
                            not math.isfinite(value):
                        continue
                    rows.append((str(name), dict(labels), float(value)))
            except Exception:    # noqa: BLE001 — a broken stats dict
                continue         # must not take down the scrape
        return rows

    def expose(self) -> str:
        """Prometheus text format 0.0.4."""
        ns = self.namespace + "_" if self.namespace else ""
        out: List[str] = []
        for name, kind, series in self._items():
            full = ns + name
            out.append(f"# TYPE {full} {kind}")
            for key, inst in sorted(series.items()):
                ls = _label_str(key)
                if kind == "histogram":
                    snap = inst.snapshot()
                    items = list(key)
                    for ub, cum in snap["buckets"]:
                        le = "+Inf" if math.isinf(ub) else repr(ub)
                        lab = _label_str(tuple(items + [("le", le)]))
                        out.append(f"{full}_bucket{lab} {cum}")
                    out.append(f"{full}_sum{ls} {snap['sum']!r}")
                    out.append(f"{full}_count{ls} {snap['count']}")
                else:
                    out.append(f"{full}{ls} {inst.value!r}")
        seen_types = set()
        for name, labels, value in sorted(
                self._collected(), key=lambda r: (r[0], sorted(r[1].items()))):
            full = ns + name
            if full not in seen_types:
                seen_types.add(full)
                out.append(f"# TYPE {full} gauge")
            out.append(f"{full}{_label_str(_label_key(labels))} "
                       f"{value!r}")
        return "\n".join(out) + ("\n" if out else "")

    def to_dict(self) -> dict:
        """Structural JSON-friendly view (the /stats-side rendering):
        ``{name: {kind, series: [{labels, ...payload}]}}``."""
        doc: Dict[str, dict] = {}
        for name, kind, series in self._items():
            rows = []
            for key, inst in sorted(series.items()):
                row = {"labels": dict(key)}
                if kind == "histogram":
                    snap = inst.snapshot()
                    snap.pop("buckets")
                    row.update(snap)
                else:
                    row["value"] = inst.value
                rows.append(row)
            doc[name] = {"kind": kind, "series": rows}
        for name, labels, value in self._collected():
            ent = doc.setdefault(name, {"kind": "gauge", "series": []})
            ent["series"].append({"labels": labels, "value": value})
        return doc

    def sample_count(self) -> int:
        """Total observations/bumps recorded across every native
        instrument (collectors excluded) — the disabled-path assertion
        surface for tests."""
        n = 0
        for _, kind, series in self._items():
            for inst in series.values():
                n += inst.count if kind == "histogram" else 1
        return n


#: shared disabled registry: every instrument it hands out is the
#: same no-op singleton
NULL = Registry(enabled=False)
