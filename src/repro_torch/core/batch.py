"""Batch (single-device) engine for prime OAC / multimodal clustering.
Port of ``repro.core.batch``.

A thin driver over the shared Stage-1/2/3 pipeline (``core.pipeline``)
with the *prime cumulus* component operator:

* Stage 1's Hadoop shuffle-by-subrelation becomes a sort of the tuple
  table by the N-1 "other" columns of each mode; every cumulus is then a
  contiguous slice of the sorted mode-k column.
* Stage 2 is an inverse-permutation gather of per-segment aggregates.
* Stage 3 dedups on order-independent 2×32-bit set signatures and
  estimates density as Alg. 7's ``#distinct generating tuples / volume``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import pipeline as P
from .context import PolyadicContext

# The unified result type; kept under its historical name.
MiningResult = P.PipelineResult


def mine(tuples: torch.Tensor, hash_lo: Sequence[torch.Tensor],
         hash_hi: Sequence[torch.Tensor], theta: float = 0.0) -> MiningResult:
    """The full three-stage prime pipeline on one device."""
    return P.mine_tuples(tuples, hash_lo, hash_hi, theta=theta)


class BatchMiner(P.PipelineMiner):
    """Multimodal clustering of a polyadic context on one device."""

    def __init__(self, sizes: Sequence[int], theta: float = 0.0,
                 seed: int = 0x5EED, packed: Optional[bool] = None,
                 sort_backend: Optional[str] = None,
                 use_kernels: Optional[bool] = None,
                 prune_values: bool = True, device=None):
        super().__init__(sizes, theta=theta, seed=seed, packed=packed,
                         sort_backend=sort_backend, use_kernels=use_kernels,
                         prune_values=prune_values, device=device)

    def mine_context(self, ctx: PolyadicContext, only_kept: bool = True):
        if ctx.sizes != self.sizes:
            raise ValueError("context sizes mismatch")
        return self.materialise(self(ctx.tuples), ctx.tuples, only_kept)
