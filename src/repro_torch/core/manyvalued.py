"""Many-valued δ-triclustering (paper §3.2) / NOAC (paper §4.3).
Port of ``repro.core.manyvalued``.

A thin driver over the shared Stage-1/2/3 pipeline (``core.pipeline``)
with the *δ-range* component operator: each mode's table is sorted by
(other columns, value), so every δ-cumulus is a contiguous value range
inside a contiguous key segment, found with two binary searches.

Validity checks (per §4.3): minimal per-mode cardinality (minsup) and
minimal density ρ_min, with density estimated as the M/R stage 3 does
(distinct generating tuples / volume).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import pipeline as P
from .context import PolyadicContext

NOACResult = P.PipelineResult        # unified result type


def noac_mine(tuples, values, hash_lo, hash_hi, delta: float,
              rho_min: float = 0.0, minsup: int = 0) -> NOACResult:
    """The full three-stage δ pipeline on one device."""
    return P.mine_tuples(tuples, hash_lo, hash_hi, values=values,
                         delta=delta, theta=rho_min, minsup=minsup)


class NOACMiner(P.PipelineMiner):
    """Many-valued (δ) multimodal clustering on one device."""

    def __init__(self, sizes: Sequence[int], delta: float,
                 rho_min: float = 0.0, minsup: int = 0, seed: int = 0x5EED,
                 packed: Optional[bool] = None,
                 sort_backend: Optional[str] = None,
                 use_kernels: Optional[bool] = None,
                 prune_values: bool = True,
                 window_budget: Optional[int] = None, device=None):
        super().__init__(sizes, theta=rho_min, delta=delta, minsup=minsup,
                         seed=seed, packed=packed,
                         sort_backend=sort_backend, use_kernels=use_kernels,
                         prune_values=prune_values,
                         window_budget=window_budget, device=device)
        self.rho_min = float(rho_min)

    def mine_context(self, ctx: PolyadicContext):
        if ctx.values is None:
            # §3.2: W={0,1}, δ=0 degenerates to prime operators
            ctx = PolyadicContext(ctx.sizes, ctx.tuples,
                                  np.zeros(ctx.num_tuples, np.float32),
                                  ctx.names)
        ctx = ctx.deduplicated()
        return self.materialise(self(ctx.tuples, ctx.values), ctx.tuples)
