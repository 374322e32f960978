"""Unified observability plane (DESIGN.md §11).  A copy of ``repro.obs``
for the port: the standard library only, so the hub, its instruments and
its exposition text are the JAX package's.

Three instruments, one hub:

* :class:`~repro_torch.obs.metrics.Registry` — process-local counters /
  gauges / log-bucketed histograms with Prometheus text exposition
  (``/metrics``) and scrape-time *collectors* that fold existing stats
  dicts in without double-writing.
* :class:`~repro_torch.obs.trace.Tracer` — structured spans with trace-id
  propagation over the :data:`~repro_torch.obs.trace.TRACE_HEADER` HTTP
  header, kept in a bounded ring (``/debug/trace``).
* :class:`~repro_torch.obs.trace.SlowQueryLog` — the N slowest requests
  with trace id, coverage and queue-wait/handler split
  (``/debug/slow``).

:class:`Obs` bundles the three for threading through the serving
plane; ``Obs.create(...)`` builds an enabled hub, :data:`NULL_OBS` is
the shared disabled hub whose instruments are all no-ops — passing
``obs=None`` anywhere means :data:`NULL_OBS`, and the enabled check is
one attribute test.
"""
from __future__ import annotations

from typing import Optional

from .metrics import (DEFAULT_BUCKET_RATIO, NULL, Counter, Gauge,
                      Histogram, NullInstrument, Registry)
from .trace import (NULL_TRACER, TRACE_HEADER, SlowQueryLog, Span,
                    Tracer, format_trace_header, parse_trace_header)

__all__ = [
    "Obs", "NULL_OBS",
    "Registry", "Counter", "Gauge", "Histogram", "NullInstrument",
    "NULL", "DEFAULT_BUCKET_RATIO",
    "Tracer", "Span", "SlowQueryLog", "TRACE_HEADER", "NULL_TRACER",
    "parse_trace_header", "format_trace_header",
]


class Obs:
    """One process's observability hub: ``metrics`` (Registry),
    ``tracer`` (Tracer) and ``slow`` (SlowQueryLog), plus the
    ``enabled`` flag hot paths test."""

    __slots__ = ("enabled", "metrics", "tracer", "slow", "service")

    def __init__(self, metrics: Registry, tracer: Tracer,
                 slow: SlowQueryLog, enabled: bool = True,
                 service: str = ""):
        self.enabled = bool(enabled)
        self.metrics = metrics
        self.tracer = tracer
        self.slow = slow
        self.service = str(service)

    @staticmethod
    def create(service: str = "", slow_query_ms: float = 100.0,
               slow_keep: int = 32, ring: int = 4096,
               namespace: str = "repro") -> "Obs":
        return Obs(Registry(enabled=True, namespace=namespace),
                   Tracer(service=service, enabled=True, ring=ring),
                   SlowQueryLog(threshold_ms=slow_query_ms,
                                keep=slow_keep),
                   enabled=True, service=service)

    @staticmethod
    def disabled() -> "Obs":
        return NULL_OBS

    def describe(self) -> dict:
        return {"enabled": self.enabled, "service": self.service,
                "spans": len(self.tracer),
                "slow": self.slow.stats() if self.enabled else None}


#: the shared disabled hub — ``obs or NULL_OBS`` is the idiom
NULL_OBS = Obs(NULL, NULL_TRACER, SlowQueryLog(threshold_ms=-1.0),
               enabled=False, service="")


def coalesce(obs: Optional[Obs]) -> Obs:
    """``obs`` or the shared disabled hub."""
    return NULL_OBS if obs is None else obs
