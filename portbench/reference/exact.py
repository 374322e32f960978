"""Plain PyTorch reference of the exact density of each row's cluster in a
triadic context (beyond the paper's Alg. 7, which estimates it).

Row t = (g0, m0, b0) spans the box X × Y × Z of its three fibers:
X = {g : (g, m0, b0) ∈ I}, Y = {m : (g0, m, b0) ∈ I}, Z = {b : (g0, m0,
b) ∈ I}.  Its exact density is |(X × Y × Z) ∩ I| / (|X| |Y| |Z|).  With
A_b the (G, M) slice I[:, :, b]:

    |(X × Y × Z) ∩ I| = Σ_b I[g0, m0, b] · (A_b0ᵀ A_b A_b0ᵀ)[m0, g0]

so each pair (b0, b) that some row needs costs two float64 matrix
products, exact for integer counts below 2**53.  Runs on any device;
TF32 never applies to float64.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .mining import to_bfloat16


def box_counts(tuples: torch.Tensor, sizes: Sequence[int]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerators, volumes) as float64 (T,) tensors on ``tuples``'
    device, for a (T, 3) integer table of distinct or repeated rows."""
    if tuples.shape[1] != 3 or len(sizes) != 3:
        raise ValueError("the exact density reference is triadic")
    g_n, m_n, b_n = (int(s) for s in sizes)
    dev = tuples.device
    g0, m0, b0 = (tuples[:, k].long() for k in range(3))
    inc = torch.zeros((g_n, m_n, b_n), dtype=torch.bool, device=dev)
    inc[g0, m0, b0] = True
    depth = inc[g0, m0, :]                       # (T, B): Z of each row
    num = torch.zeros(tuples.shape[0], dtype=torch.float64, device=dev)
    x_size = torch.zeros_like(num)
    y_size = torch.zeros_like(num)
    for b in range(b_n):
        rows = torch.nonzero(b0 == b).reshape(-1)
        if rows.numel() == 0:
            continue
        a0 = inc[:, :, b].to(torch.float64)
        x_size[rows] = a0.sum(0)[m0[rows]]
        y_size[rows] = a0.sum(1)[g0[rows]]
        for c in range(b_n):
            z = depth[rows, c]
            if not bool(z.any()):
                continue
            prod = a0.t() @ (inc[:, :, c].to(torch.float64) @ a0.t())
            num[rows] += z.to(torch.float64) * prod[m0[rows], g0[rows]]
            del prod
    vol = x_size * y_size * depth.sum(1).to(torch.float64)
    return num, vol


def exact_densities(tuples: torch.Tensor, sizes: Sequence[int], *,
                    bfloat16: bool = False) -> torch.Tensor:
    """Exact densities as float64 (T,) on the host; ``bfloat16`` gives
    the control: the float32 quotient rounded to bfloat16."""
    num, vol = box_counts(tuples, sizes)
    dens = (num / torch.clamp(vol, min=1.0)).cpu()
    if bfloat16:
        dens = torch.from_numpy(to_bfloat16(
            dens.to(torch.float32).numpy())).to(torch.float64)
    return dens
