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
take another 39.6 GB at granite-moe-3b-a800m's width.

ZeRO-1 (``zero1_spec``, ``zero1_shardings``): master parameters and both
moments are sharded over the data axes too, on the first free dimension
that divides, as the JAX package lays them out.  Over a mesh
``adamw_update`` updates this rank's blocks; its global norm sums the
squares of the blocks each rank owns (``Sharding.owner``: a block
replicated over some axes counts once) and ``psum``s them over the whole
mesh.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.params import map_defs, tree_items, tree_map
from ..sharding.rules import PartitionSpec, Sharding


def zero1_spec(base: PartitionSpec, shape: tuple, rules) -> PartitionSpec:
    """Extend ``base`` with the data axes on the first divisible free dim."""
    data_axes = tuple(a for a in ("pod", "data")
                      if a in rules.mesh.axis_names)
    if not data_axes:
        return base
    dsize = int(math.prod(rules.mesh.shape[a] for a in data_axes))
    entries = list(base) + [None] * (len(shape) - len(base))
    used = set()
    for e in entries:
        if e is None:
            continue
        used.update(e if isinstance(e, tuple) else (e,))
    if any(a in used for a in data_axes):
        return base
    for i, e in enumerate(entries):
        if e is None and shape[i] % dsize == 0:
            entries[i] = data_axes if len(data_axes) > 1 else data_axes[0]
            return PartitionSpec(*entries)
    return base  # nothing divides: stay TP-sharded/replicated


def zero1_shardings(defs, rules):
    """``Sharding`` tree for master params / moments (ZeRO-1 layout)."""
    def one(d):
        base = rules.spec(d.axes, d.shape)
        return Sharding(rules.mesh, zero1_spec(base, d.shape, rules))
    return map_defs(one, defs)


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
                 grad_clip: Optional[float] = 1.0, norm_comm=None,
                 owned: Optional[list] = None):
    """One AdamW step on fp32 master params, in place.  ``grads`` is a tree
    of float32 gradients shaped like ``params`` (scaled in place by the
    clip).  Returns (params, opt, gnorm): the same ``params`` tree and
    moment tensors, ``opt["step"]`` a new tensor one larger, ``gnorm`` the
    global norm before clipping (zero without a clip).  Over a mesh:
    ``owned`` (per leaf in ``tree_items`` order, whether this rank's block
    counts in the norm) and ``norm_comm`` (collectives over every mesh
    axis)."""
    ps = [p for _, p in tree_items(params)]
    gs = [g for _, g in tree_items(grads)]
    ms = [m for _, m in tree_items(opt["m"])]
    vs = [v for _, v in tree_items(opt["v"])]
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError(f"{len(ps)} parameters, {len(gs)} gradients, "
                         f"{len(ms)} / {len(vs)} moments")
    step = opt["step"] + 1
    if grad_clip is not None:
        sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                 for i, g in enumerate(gs) if owned is None or owned[i])
        if not isinstance(sq, torch.Tensor):      # owns no block
            sq = torch.zeros((), dtype=torch.float32, device=ps[0].device)
        if norm_comm is not None:
            sq = norm_comm.psum(sq)
        gnorm = torch.sqrt(sq)
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
