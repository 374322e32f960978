"""Cross-process trace spans for the serving plane (DESIGN.md §11).  A
copy of ``repro.obs.trace``.

A *span* is one timed unit of work — a router dispatch, one per-shard
attempt, a replica's handler — recorded on ``time.monotonic`` (duration
is exact within a process) plus a wall-clock start (rough cross-process
ordering).  Spans carry a **trace id** minted at the plane's edge and
propagated to backends via the :data:`TRACE_HEADER` HTTP header, so
the spans one logical request produced in the router process, the
shard writers and the replica readers stitch back together by that one
id — including the attempts that *failed*: retries, circuit-breaker
skips and degraded drops each leave a span with a ``status`` saying
why.

Header contract: ``X-Repro-Trace: <trace_id>/<parent_span_id>`` — both
lowercase hex, minted by :meth:`Tracer.new_id`.  A server receiving
the header adopts the trace id and records the parent span id; a
server receiving none mints a fresh trace (it is the edge).  The
header is advisory: a malformed value means "no trace", never an
error.

Each process keeps its spans in a bounded ring (old spans fall off;
tracing a long-running plane must not leak).  ``spans()`` filters by
trace id, ``export_jsonl()`` dumps the ring for offline stitching, and
the ``/debug/trace`` endpoints expose it over HTTP.  A disabled tracer
(:data:`NULL_TRACER`) hands every caller the same no-op span — the
hot-path cost of tracing-off is one attribute test.

The slow-query log rides on the same ids: a bounded
:class:`SlowQueryLog` keeps the N *slowest* requests past a threshold
with their trace id, shard coverage and queue-wait/handler split, so
"what was that 2-second query?" is answerable from ``/debug/slow``
without scraping every span.
"""
from __future__ import annotations

import collections
import heapq
import json
import os
import random
import threading
import time
from typing import List, Optional

__all__ = ["TRACE_HEADER", "Span", "Tracer", "SlowQueryLog",
           "NULL_TRACER", "parse_trace_header", "format_trace_header"]

#: the propagation header: ``<trace_id>/<parent_span_id>``
TRACE_HEADER = "X-Repro-Trace"

#: per-process id stream, seeded once from the OS entropy pool — ids
#: only need uniqueness, not unpredictability, and a PRNG draw is a
#: few times cheaper than an os.urandom syscall per span
_ids = random.Random(os.urandom(16))
_ids_lock = threading.Lock()


def format_trace_header(trace_id: str, span_id: str) -> str:
    return f"{trace_id}/{span_id}"


def parse_trace_header(value) -> tuple:
    """``(trace_id, parent_span_id)`` — ``(None, None)`` for a missing
    or malformed header (advisory: never raises)."""
    if not value or not isinstance(value, str):
        return None, None
    tid, _, pid = value.partition("/")
    tid, pid = tid.strip(), pid.strip()
    if not tid or not all(c in "0123456789abcdef" for c in tid):
        return None, None
    return tid, (pid or None)


class Span:
    """One open span; close it via the ``Tracer.span`` context manager
    (or :meth:`finish`).  ``set(k, v)`` attaches attributes (shard,
    attempt, endpoint, outcome...); ``error(msg)`` marks failure."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "service", "start_wall", "_t0", "attrs", "status",
                 "dur_ms")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str]):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.service = tracer.service
        self.start_wall = time.time()
        self._t0 = time.monotonic()
        self.attrs: dict = {}
        self.status = "ok"
        self.dur_ms: Optional[float] = None

    def set(self, key: str, value) -> "Span":
        self.attrs[str(key)] = value
        return self

    def error(self, message: str) -> "Span":
        self.status = "error"
        self.attrs["error"] = str(message)
        return self

    def header(self) -> str:
        """Header value that makes downstream spans children of this
        one."""
        return format_trace_header(self.trace_id, self.span_id)

    def finish(self) -> None:
        # hot path: just stamp the duration and enqueue the object —
        # the dict view is materialised lazily at read time (spans())
        if self.dur_ms is None:
            self.dur_ms = (time.monotonic() - self._t0) * 1e3
            self.tracer._record(self)

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "service": self.service, "status": self.status,
                "start_wall": self.start_wall, "dur_ms": self.dur_ms,
                "pid": os.getpid(), "attrs": dict(self.attrs)}


class _NullSpan:
    """Shared no-op span: same surface, nothing recorded, no ids."""

    __slots__ = ()
    trace_id = ""
    span_id = ""
    parent_id = None
    status = "ok"

    def set(self, key, value):
        return self

    def error(self, message):
        return self

    def header(self) -> Optional[str]:
        return None

    def finish(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("_span",)

    def __init__(self, span: Span):
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, etype, evalue, tb) -> bool:
        if etype is not None and self._span.status == "ok":
            self._span.error(f"{etype.__name__}: {evalue}")
        self._span.finish()
        return False


class Tracer:
    """Per-process span factory + bounded ring."""

    def __init__(self, service: str = "", enabled: bool = True,
                 ring: int = 4096):
        self.service = str(service)
        self.enabled = bool(enabled)
        self._ring: collections.deque = collections.deque(
            maxlen=max(16, int(ring)))
        self._lock = threading.Lock()
        self.dropped = 0

    @staticmethod
    def new_id() -> str:
        with _ids_lock:
            return f"{_ids.getrandbits(64):016x}"

    def span(self, name: str, trace_id: Optional[str] = None,
             parent_id: Optional[str] = None, **attrs):
        """Context manager yielding a :class:`Span` (no-op span when
        disabled).  Without an explicit ``trace_id`` a fresh trace is
        minted — this span is the trace's edge/root."""
        if not self.enabled:
            return _NULL_SPAN
        sp = Span(self, str(name),
                  trace_id if trace_id else self.new_id(),
                  self.new_id(), parent_id)
        if attrs:
            sp.attrs.update(attrs)
        return _SpanCtx(sp)

    def start(self, name: str, trace_id: Optional[str] = None,
              parent_id: Optional[str] = None, **attrs):
        """Manual-finish variant (handlers that reply before closing
        the span); returns the no-op span when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        sp = Span(self, str(name),
                  trace_id if trace_id else self.new_id(),
                  self.new_id(), parent_id)
        if attrs:
            sp.attrs.update(attrs)
        return sp

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)

    # -- views ----------------------------------------------------------------

    def spans(self, trace_id: Optional[str] = None,
              limit: int = 0) -> List[dict]:
        """Finished spans, oldest first; filtered by ``trace_id`` when
        given, tail-truncated to ``limit`` when > 0."""
        with self._lock:
            out = list(self._ring)
        if trace_id:
            out = [s for s in out if s.trace_id == trace_id]
        if limit > 0:
            out = out[-int(limit):]
        return [s.to_dict() for s in out]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def export_jsonl(self, path: str,
                     trace_id: Optional[str] = None) -> int:
        """Append the (filtered) ring as JSON lines; returns the number
        of spans written."""
        spans = self.spans(trace_id)
        with open(path, "a", encoding="utf-8") as fh:
            for s in spans:
                fh.write(json.dumps(s) + "\n")
        return len(spans)


#: shared disabled tracer
NULL_TRACER = Tracer(enabled=False, ring=16)


class SlowQueryLog:
    """Bounded record of the ``keep`` slowest requests at or above
    ``threshold_ms``: a min-heap keyed by total latency, so a new slow
    query evicts the *least* slow of the kept set.  Disabled when
    ``threshold_ms < 0``."""

    def __init__(self, threshold_ms: float = 100.0, keep: int = 32):
        self.threshold_ms = float(threshold_ms)
        self.keep = max(1, int(keep))
        self._lock = threading.Lock()
        self._heap: list = []           # (total_ms, seq, record)
        self._seq = 0
        self.recorded = 0

    @property
    def enabled(self) -> bool:
        return self.threshold_ms >= 0

    def record(self, endpoint: str, total_ms: float, *,
               handler_ms: Optional[float] = None,
               wait_ms: Optional[float] = None,
               trace_id: str = "", coverage=None,
               detail: Optional[dict] = None) -> bool:
        """Consider one finished request; returns True when kept."""
        if not self.enabled or total_ms < self.threshold_ms:
            return False
        rec = {"endpoint": str(endpoint), "total_ms": float(total_ms),
               "handler_ms": (None if handler_ms is None
                              else float(handler_ms)),
               "wait_ms": None if wait_ms is None else float(wait_ms),
               "trace_id": str(trace_id), "wall": time.time()}
        if coverage is not None:
            rec["coverage"] = [int(s) for s in coverage]
        if detail:
            rec.update(detail)
        with self._lock:
            self.recorded += 1
            self._seq += 1
            item = (float(total_ms), self._seq, rec)
            if len(self._heap) < self.keep:
                heapq.heappush(self._heap, item)
                return True
            if total_ms > self._heap[0][0]:
                heapq.heapreplace(self._heap, item)
                return True
        return False

    def entries(self) -> List[dict]:
        """Kept records, slowest first."""
        with self._lock:
            items = sorted(self._heap, reverse=True)
        return [rec for _, _, rec in items]

    def stats(self) -> dict:
        with self._lock:
            return {"threshold_ms": self.threshold_ms,
                    "keep": self.keep, "kept": len(self._heap),
                    "recorded": self.recorded}
