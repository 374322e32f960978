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

The module adds the dense validation backend (contexts whose cells fit
the card; the exact density oracle, through the ``tricluster_density``
kernel for triadic contexts on CUDA).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from ..kernels import ops, ref
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
                 prune_values: bool = True,
                 window_budget: Optional[int] = None, device=None):
        super().__init__(sizes, theta=theta, seed=seed, packed=packed,
                         sort_backend=sort_backend, use_kernels=use_kernels,
                         prune_values=prune_values,
                         window_budget=window_budget, device=device)

    def mine_context(self, ctx: PolyadicContext, only_kept: bool = True):
        if ctx.sizes != self.sizes:
            raise ValueError("context sizes mismatch")
        return self.materialise(self(ctx.tuples), ctx.tuples, only_kept)


# ---------------------------------------------------------------------------
# Dense backend (contexts whose cells fit the card; validation + exact
# density)
# ---------------------------------------------------------------------------

#: Elements of the largest intermediate of the N-ary contraction in
#: :func:`exact_density_dense` (float32): at most 256 MiB.
DENSE_CHUNK_ELEMS = 1 << 26


def dense_tensor(tuples: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """Dense boolean incidence tensor via scatter (idempotent under dups),
    on the device of ``tuples``.  The flat cell index is int32, as in the
    JAX package, so Π sizes must stay below 2**31 (BibSonomy's 4.6e12
    cells cannot be densified): ``ValueError`` otherwise."""
    cells = math.prod(int(s) for s in sizes)
    if cells >= 2**31:
        raise ValueError(f"dense_tensor: {cells} cells (sizes {tuple(sizes)}) "
                         "overflow the int32 flat index; the dense backend "
                         "is for contexts below 2**31 cells")
    flat = torch.zeros((cells,), dtype=torch.bool, device=tuples.device)
    idx = torch.zeros((tuples.shape[0],), dtype=torch.int32,
                      device=tuples.device)
    for k, s in enumerate(sizes):
        idx = idx * int(s) + tuples[:, k].to(torch.int32)
    flat[idx.to(torch.int64)] = True
    return flat.reshape(tuple(int(s) for s in sizes))


def fibers(tensor: torch.Tensor, tuples: torch.Tensor) -> List[torch.Tensor]:
    """Prime sets of each generating tuple: the N fibers through it.

    Returns a list over modes of (T, n_k) boolean masks — the tricluster
    extent/intent/modus of the paper's §2 in mask form."""
    n = tuples.shape[1]
    out = []
    for k in range(n):
        flat = torch.movedim(tensor, k, -1).reshape(-1, tensor.shape[k])
        idx = torch.zeros((tuples.shape[0],), dtype=torch.int64,
                          device=tuples.device)
        for j in range(n):
            if j != k:
                idx = idx * tensor.shape[j] + tuples[:, j].to(torch.int64)
        out.append(flat[idx])
    return out


def _contract(tensor: torch.Tensor, masks: Sequence[torch.Tensor],
              chunk_elems: int = DENSE_CHUNK_ELEMS) -> torch.Tensor:
    """num[t] = Σ Π_k masks[k][t, i_k] · tensor[i_1, ..., i_N] in float32,
    any N.  Rows t go in chunks; each chunk contracts mode 0 by one matrix
    product, then the remaining modes one at a time, so the largest
    intermediate is (rows, Π_{k>0} n_k) with rows sized to stay below
    ``chunk_elems`` elements — never T × (two modes) at full T."""
    t = masks[0].shape[0]
    shape = tuple(tensor.shape)
    rest = math.prod(shape[1:])
    tf = tensor.to(torch.float32).reshape(shape[0], rest)
    rows = max(1, chunk_elems // max(rest, 1))
    out = torch.empty((t,), dtype=torch.float32, device=tensor.device)
    for lo in range(0, t, rows):
        r = masks[0][lo:lo + rows].to(torch.float32) @ tf  # (rows, rest)
        for k in range(1, len(masks)):
            r = r.reshape(r.shape[0], shape[k], -1)
            mk = masks[k][lo:lo + rows].to(torch.float32)
            r = (r * mk[:, :, None]).sum(1)                # drop mode k
        out[lo:lo + rows] = r.reshape(-1)
    return out


def exact_density_dense(tensor: torch.Tensor,
                        masks: Sequence[torch.Tensor], *,
                        use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Exact density |box ∩ I| / vol for each tuple's cluster (beyond the
    paper).  ``masks`` — list over modes of (T, n_k) bool.

    Triadic contexts go through ``ops.exact_density``: on a CUDA tensor the
    ``tricluster_density`` kernel (the TPU kernel's role as this
    function's triadic fast path), on a CPU tensor its plain version.
    Other arities run the plain chunked contraction (:func:`_contract`)
    wherever the tensor lies: the TPU package has no kernel for N != 3
    either.  ``use_kernels`` as in ``kernels.ops``."""
    if len(masks) == 3:
        return ops.exact_density(tensor, *masks, use_kernels=use_kernels)
    num = _contract(tensor, masks)
    vol = torch.ones((masks[0].shape[0],), dtype=torch.float32,
                     device=tensor.device)
    for m in masks:
        vol = vol * ref.row_counts(m)
    return num / torch.clamp(vol, min=1.0)
