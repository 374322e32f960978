"""Dry-trace analysis: op counting, collectives and roofline terms (the
twin of ``repro.analysis``)."""
from .ops import (CollectiveStats, OpsProfile, parse_collectives,
                  profile_call)
from .roofline import (HW, RooflineReport, model_flops, roofline_from_trace,
                       roofline_report)

__all__ = ["CollectiveStats", "OpsProfile", "parse_collectives",
           "profile_call", "HW", "RooflineReport", "model_flops",
           "roofline_from_trace", "roofline_report"]
