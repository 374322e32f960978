"""The comparison that decides ``correct``: what a sampled request
produced against the plain reference of its context.

Numbers compared, each with its limit (``limits/<cell>.json``):

* ``mismatched``: elements of the exact leaves (``sig_lo``, ``sig_hi``,
  ``gen_count``, ``keep``, ``cardinalities``, ``range_lo``,
  ``range_hi``, ``sorted_e``) that differ, summed over the samples; a
  leaf of the wrong shape counts every element;
* ``density_rel_err``: the largest relative gap between the float32
  Alg. 7 density and the exact float64 quotient it rounds;
* ``exact_rel_err`` (cells with exact densities): the same for the
  exact densities of the dense path.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

EXACT_LEAVES = ("sig_lo", "sig_hi", "gen_count", "keep", "cardinalities",
                "range_lo", "range_hi", "sorted_e")


def mismatches(got: np.ndarray, want: np.ndarray) -> int:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return int(max(got.size, want.size, 1))
    return int(np.count_nonzero(got != want))


def rel_err(got: np.ndarray, exact: np.ndarray) -> float:
    """max |got - exact| / |exact| (exact > 0); inf for a shape that
    differs or a value that is not finite."""
    got = np.asarray(got, np.float64)
    exact = np.asarray(exact, np.float64)
    if got.shape != exact.shape or not np.isfinite(got).all():
        return float("inf")
    if got.size == 0:
        return 0.0
    return float((np.abs(got - exact) / np.abs(exact)).max())


def numbers(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
            ) -> Dict[str, float]:
    """The compared numbers of one request.  Signature leaves are
    compared as uint32 bit patterns."""
    miss = 0
    for leaf in EXACT_LEAVES:
        g = got[leaf]
        if leaf.startswith("sig"):
            g = np.asarray(g).view(np.uint32)
        miss += mismatches(g, np.asarray(want[leaf]).view(np.uint32)
                           if leaf.startswith("sig") else want[leaf])
    out = {"mismatched": float(miss),
           "density_rel_err": rel_err(got["density"],
                                      want["density_exact"])}
    if "exact_density" in want:
        out["exact_rel_err"] = rel_err(got.get("exact_density", []),
                                       want["exact_density"])
    return out


def combine(per_request: List[Dict[str, float]]) -> Dict[str, float]:
    """Counts summed, relative errors their largest, over requests."""
    out: Dict[str, float] = {}
    for nums in per_request:
        for k, v in nums.items():
            out[k] = out.get(k, 0.0) + v if k == "mismatched" \
                else max(out.get(k, 0.0), v)
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit, and every limit's number read."""
    return all(k in nums and nums[k] <= lim for k, lim in limits.items())
