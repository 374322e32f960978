"""Peak device-allocation probe for the windowed pipeline.  Port of
``repro.core.memprobe``.

Two measurement sources, one per device kind, and no fallback between
them:

* a CUDA device: the caching allocator's ``allocated_bytes.all.current``
  (what ``torch.cuda.memory_allocated`` reads) — bytes held by live
  tensors.  If it cannot be read there, the call raises: a CUDA device
  is never reported by the host's RSS.
* the CPU: the process's peak resident set (``resource.getrusage``),
  as the JAX package does where it has no allocator stats.  Peak RSS
  only grows, so deltas from it are a coarse upper bound.

``MemProbe`` is the ``probe`` callback of ``core.windowed``: call it with
a stage name at each sampling point; ``peak_bytes`` / ``stages`` report
high-water deltas from the construction-time baseline.
"""
from __future__ import annotations

from typing import Dict

import torch


def device_bytes(device="cuda") -> int:
    """Bytes allocated on ``device`` now (CUDA), or the process's peak
    resident set (CPU); see the module docstring."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device to probe ({device})")
        torch.cuda.init()
        stats = torch.cuda.memory_stats(device)
        if "allocated_bytes.all.current" not in stats:
            raise RuntimeError(
                f"CUDA allocator statistics unreadable on {device}")
        return int(stats["allocated_bytes.all.current"])
    if device.type != "cpu":
        raise ValueError(f"no allocation probe for device {device}")
    import resource
    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)


class MemProbe:
    """High-water allocation tracker relative to a baseline sample."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.baseline = device_bytes(self.device)
        self.stages: Dict[str, int] = {}
        self.peak_bytes = 0

    def __call__(self, stage: str = "total") -> int:
        delta = max(0, device_bytes(self.device) - self.baseline)
        self.stages[stage] = max(self.stages.get(stage, 0), delta)
        self.peak_bytes = max(self.peak_bytes, delta)
        return delta

    def report(self) -> Dict[str, int]:
        return {"peak_bytes": int(self.peak_bytes),
                "stages": {k: int(v) for k, v in sorted(self.stages.items())}}


def measure_result_bytes(result) -> int:
    """Device bytes held live by a ``PipelineResult`` (0 for host
    leaves) — what a monolithic run keeps resident after it returns."""
    import dataclasses
    total = 0
    for f in dataclasses.fields(result):
        leaf = getattr(result, f.name)
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            total += leaf.numel() * leaf.element_size()
    return total
