"""Hand-rolled AdamW on fp32 master parameters, and the warmup-cosine
schedule.  Port of ``repro.train.optim``.

Every number is float32 and comes from the JAX function's operations in
its order: ``lr`` from float32 tensor ops (``pi * prog`` and ``cos`` in
float32, not Python's float64 ``math``), the global norm
``sqrt(sum_leaves sum g^2)``, ``scale = min(1, clip / max(gnorm,
1e-9))``, then ``m``, ``v``, ``mh``, ``vh`` and ``p - lr * (mh /
(sqrt(vh) + eps) + wd * p)``.  ``torch.optim.AdamW`` applies the decay
as a separate multiply and rounds otherwise.  A scalar divisor is a
float32 tensor on the leaves' device, not a Python number: CUDA divides
by a host scalar through its reciprocal, which rounds otherwise.

``adamw_update`` writes the parameters, the moments and the gradients
in place (under ``torch.no_grad``), the analogue of the JAX step's
``donate_argnums``: a functional copy of params, ``m`` and ``v`` would
take another 39.6 GB at granite-moe-3b-a800m's width.  The ZeRO-1
sharding helpers come with the model on a mesh (ROADMAP A13c).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.lm import not_ported
from ..models.params import tree_items, tree_map


def zero1_spec(*args, **kwargs):
    raise not_ported("zero1_spec (ZeRO-1 state sharding over a mesh)",
                     "A13c")


def zero1_shardings(*args, **kwargs):
    raise not_ported("zero1_shardings (ZeRO-1 state sharding over a mesh)",
                     "A13c")


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 scalar tensor on ``like``'s device (a fill:
    no host synchronisation)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def adamw_init(params) -> dict:
    """Zero moments shaped like ``params`` and an int32 step counter."""
    leaf = tree_items(params)[0][1]
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                                     requires_grad=False),
                          params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32,
                                                     requires_grad=False),
                          params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def adamw_update(params, grads, opt, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0):
    """One AdamW step on fp32 master params, in place.  ``grads`` is a tree
    of float32 gradients shaped like ``params`` (scaled in place by the
    clip).  Returns (params, opt, gnorm): the same ``params`` tree and
    moment tensors, ``opt["step"]`` a new tensor one larger, ``gnorm`` the
    global norm before clipping (zero without a clip)."""
    ps = [p for _, p in tree_items(params)]
    gs = [g for _, g in tree_items(grads)]
    ms = [m for _, m in tree_items(opt["m"])]
    vs = [v for _, v in tree_items(opt["v"])]
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError(f"{len(ps)} parameters, {len(gs)} gradients, "
                         f"{len(ms)} / {len(vs)} moments")
    step = opt["step"] + 1
    if grad_clip is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                               for g in gs))
        scale = torch.clamp(
            _f32(grad_clip, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
        for g in gs:
            g.mul_(scale)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=ps[0].device)
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for p, g, m, v in zip(ps, gs, ms, vs):
        g = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        mh = m / bc1
        den = torch.div(v, bc2).sqrt_().add_(eps)
        upd = mh.div_(den).add_(weight_decay * p)
        del den
        p.sub_(upd.mul_(lr))
    return params, {"m": opt["m"], "v": opt["v"], "step": step}, gnorm


def cosine_lr(step: torch.Tensor, *, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to floor_frac·peak (float32)."""
    s = step.to(torch.float32)
    warm = peak * s / _f32(max(warmup, 1), s)
    prog = torch.clamp((s - warmup) / _f32(max(total - warmup, 1), s),
                       0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac)
                  * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
