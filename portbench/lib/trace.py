"""What a run hands the metric readers: its counts and host times, and in
a traced run the profiler's device records and the benchmark's own
spans, on the profiler's clock.

A traced run profiles the window with ``torch.profiler`` (CPU and CUDA
activities).  The benchmark names its own spans with
``record_function("portbench.<name>")``; the device records are every
kernel, copy and set the card ran.  Records are read raw, without the
profiler's operator tree, which takes minutes to build for a window of
hundreds of requests.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from . import stats

SPAN_PREFIX = "portbench."
METRICS_DIR = Path(__file__).resolve().parents[1] / "metrics"


@dataclasses.dataclass(frozen=True)
class Record:
    """One interval on the profiler's clock, in ns."""
    name: str
    start: int
    end: int


def _raw_events(prof):
    """(name, is_device, start ns, end ns) of every profiler record, read
    from the kineto results; a profiler without them raises."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        raise RuntimeError("the profiler holds no kineto results: this "
                           "torch cannot give the device records raw")
    for ev in results.events():
        start = ev.start_ns()
        yield ev.name(), ev.device_type() == cuda, int(start), \
            int(start + ev.duration_ns())


def read_profile(prof) -> Tuple[List[Record], List[Record]]:
    """(device records, the benchmark's spans) of a finished profile,
    each sorted by start; span names lose the ``portbench.`` prefix."""
    device, spans = [], []
    for name, on_device, start, end in _raw_events(prof):
        if not name.startswith(SPAN_PREFIX):
            if on_device:
                device.append(Record(name, start, end))
        elif not on_device:
            # a span is also drawn on the device's timeline (a GPU user
            # annotation over its kernels): that copy is not device work
            spans.append(Record(name[len(SPAN_PREFIX):], start, end))
    device.sort(key=lambda r: r.start)
    spans.sort(key=lambda r: r.start)
    return device, spans


def kernel_layers() -> dict:
    """The frozen map from device record names to layers and to the
    port's kernels (``metrics/kernel_layers.json``)."""
    with open(METRICS_DIR / "kernel_layers.json") as f:
        return json.load(f)


def matches(name: str, patterns: Sequence[str]) -> bool:
    return any(p in name for p in patterns)


@dataclasses.dataclass
class RunView:
    """Everything a metric reader may read of one run.

    Host side: ``requests`` completed in the window, their
    ``latencies_s``, the ``tuples`` they mined, the window's length
    ``window_s``, ``setup_s``, the device's ``peak_bytes``, the port's
    kernel ``launches`` in the window, and the configuration's ``sizes``.
    A traced run adds the ``device`` records and ``spans`` inside the
    traced window ``window_ns`` and ``event_ms``: device ms between CUDA
    events around the benchmark's own spans, summed over the window's
    requests."""
    requests: int
    latencies_s: List[float]
    tuples: int
    window_s: float
    setup_s: float
    peak_bytes: int
    launches: Dict[str, int]
    sizes: Tuple[int, ...]
    n_tuples: int
    device: Optional[List[Record]] = None
    spans: Optional[List[Record]] = None
    window_ns: Optional[Tuple[int, int]] = None
    event_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def traced(self) -> bool:
        return self.device is not None

    def busy_ns(self, patterns: Optional[Sequence[str]] = None) -> int:
        """Length of the union of the device records in the window whose
        names hold one of ``patterns`` (all of them: None)."""
        lo, hi = self.window_ns
        return stats.covered(stats.clip(
            [(r.start, r.end) for r in self.device
             if patterns is None or matches(r.name, patterns)], lo, hi))

    def layer_ms(self, layer: str) -> Optional[float]:
        """Device ms a request of the layer's records (the frozen map's
        ``layers``), or None when none was traced."""
        if not self.traced or not self.requests:
            return None
        busy = self.busy_ns(kernel_layers()["layers"][layer])
        return busy / 1e6 / self.requests if busy else None


def lost_records(view: RunView) -> Dict[str, Tuple[int, int]]:
    """{port kernel: (records traced, launches counted)} for each port
    kernel launched in the window."""
    names = kernel_layers()["port_kernels"]
    out = {}
    for kernel, cuda_name in names.items():
        launched = view.launches.get(kernel, 0)
        if launched:
            seen = sum(1 for r in view.device if cuda_name in r.name)
            out[kernel] = (seen, launched)
    return out


def innermost(spans: List[Record], starts: List[int], at: int) -> str:
    """Name of the innermost of the nested ``spans`` (sorted by start,
    ``starts`` their starts) that holds time ``at``; ``window`` if
    none: an inner span starts after the spans that hold it."""
    i = bisect.bisect_right(starts, at) - 1
    while i >= 0 and spans[i].end <= at:
        i -= 1
    return spans[i].name if i >= 0 else "window"


def breakdown(view: RunView, top: int = 10) -> dict:
    """The device operations that took most time in the window, and the
    window's idle time by the innermost benchmark span the host was in
    (``window`` where no request ran), each as [name, seconds]."""
    lo, hi = view.window_ns
    by_op: Dict[str, float] = {}
    for r in view.device:
        s, e = max(r.start, lo), min(r.end, hi)
        if e > s:
            by_op[r.name] = by_op.get(r.name, 0.0) + (e - s) / 1e9
    idle: Dict[str, float] = {}
    spans = sorted(view.spans, key=lambda r: (r.start, -r.end))
    starts = [sp.start for sp in spans]
    for s, e in stats.gaps([(r.start, r.end) for r in view.device], lo, hi):
        name = innermost(spans, starts, (s + e) // 2)
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(by_op), "idle_gaps": rank(idle)}
