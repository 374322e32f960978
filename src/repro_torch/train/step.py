"""The train step: bf16 compute over fp32 master parameters, gradient
accumulation, optional gradient compression, remat.  Port of
``repro.train.step``.

``make_train_step(cfg)`` returns ``train_step(state, batch) -> (state,
metrics)``, which runs eagerly and updates ``state`` in place (see
``optim.adamw_update``); ``jit_train_step`` is the same function (the
port compiles nothing).  The state is the JAX package's tree:
``{"params", "opt": {"m", "v", "step"}, "data_step"}``, with int32
scalars, so checkpoints of either package restore in the other
(``train.checkpoints``) and :func:`from_jax_state` carries a JAX state
over.

Each step casts the whole fp32 master tree to the compute dtype once,
through an ``autograd.Function`` whose backward rounds the cotangent
through bfloat16 when ``tc.grad_compress`` and returns it as float32
(the JAX step's ``_cast_with_grad_layout``, whose sharding constraints
are the only part left out).  The model's own ``.to(x.dtype)`` casts are
then no-ops.  ``tc.zero1`` is read and changes nothing on one device,
where it is only a layout; so is ``cfg.microbatch`` apart from its
numbers (the gradients summed in microbatch order from zeros, then
divided).

Refused before the first step: a device mesh (``rules``, the sharding
trees; ROADMAP A13c), the families A13d-f, and the kernel switches
(``attn_impl="pallas"``, ``use_pallas``): neither package has a backward
for those kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models.api import get_model
from ..models.lm import _FAMILY_ITEMS, compute_dtype, not_ported
from ..models.params import (from_jax_params, tree_from_items, tree_items,
                             tree_map)
from .optim import adamw_init, adamw_update, cosine_lr


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    grad_compress: bool = False    # bf16 gradients on the wire
    zero1: bool = True             # shard master/m/v over data axes


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> dict:
    """Master params (fp32, trainable) + AdamW moments + data cursor, on
    ``device`` (default: the card; ``generator`` lives there too)."""
    params = get_model(cfg).init(cfg, generator, dtype, device,
                                 requires_grad=True)
    return {"params": params, "opt": adamw_init(params),
            "data_step": torch.zeros((), dtype=torch.int32,
                                     device=resolve_device(device))}


def from_jax_state(state, device=None) -> dict:
    """A train state in the JAX package's layout (params, ``opt.m``,
    ``opt.v``, ``opt.step``, ``data_step``; arrays or anything
    ``np.asarray`` takes, such as a checkpoint restored without a device)
    as the port's, on ``device`` (default: the card)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.from_numpy(np.array(np.asarray(a, np.float32))).to(dev)

    def i32(a):
        return torch.from_numpy(np.array(np.asarray(a, np.int32))).to(dev)
    return {"params": from_jax_params(state["params"], dev,
                                      requires_grad=True),
            "opt": {"m": tree_map(f32, state["opt"]["m"]),
                    "v": tree_map(f32, state["opt"]["v"]),
                    "step": i32(state["opt"]["step"])},
            "data_step": i32(state["data_step"])}


def state_shardings(*args, **kwargs):
    raise not_ported("state_shardings (the train state over a mesh)", "A13c")


def state_structs(*args, **kwargs):
    raise not_ported("state_structs (the sharded dry-run state)", "A13c")


class _ComputeCast(torch.autograd.Function):
    """fp32 master leaf -> compute dtype; the cotangent comes back through
    ``wire`` (bfloat16 = gradient compression) as float32."""

    @staticmethod
    def forward(ctx, p, dtype, wire):
        ctx.wire = wire
        return p.to(dtype) if p.dtype != dtype else p.view_as(p)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.wire).to(torch.float32), None, None


def check_trainable(cfg: ModelConfig, rules=None) -> None:
    """Raise before the first step for what the port cannot train."""
    if rules is not None:
        raise not_ported("make_train_step over a device mesh (rules)",
                         "A13c")
    if cfg.family not in ("dense", "moe"):
        raise not_ported(f"training the {cfg.family!r} family",
                         _FAMILY_ITEMS.get(cfg.family, "A13"))
    if cfg.attn_impl == "pallas" or cfg.use_pallas:
        raise NotImplementedError(
            f"{cfg.name}: training with attn_impl={cfg.attn_impl!r}, "
            f"use_pallas={cfg.use_pallas}: the flash_attention and rmsnorm "
            "kernels have no backward, in the JAX package or in the port; "
            "train with attn_impl='blocked' (or 'einsum') and "
            "use_pallas=False")


def _split_microbatches(batch: dict, n: int) -> list:
    for k, a in batch.items():
        if a.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {a.shape[0]} rows, not a "
                             f"multiple of microbatch={n}")
    return [{k: a.reshape(n, a.shape[0] // n, *a.shape[1:])[i]
             for k, a in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, rules=None,
                    tc: TrainConfig = TrainConfig()):
    check_trainable(cfg, rules)
    model = get_model(cfg)
    compute = compute_dtype(cfg)
    wire = torch.bfloat16 if tc.grad_compress else torch.float32

    def grad_of(leaves, paths, mb):
        cast = tree_from_items(
            (path, _ComputeCast.apply(p, compute, wire))
            for path, p in zip(paths, leaves))
        loss, metrics = model.loss(cfg, cast, mb)
        del cast
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(),
                {k: v.detach() for k, v in metrics.items()}), list(grads)

    def train_step(state, batch):
        master = state["params"]
        items = tree_items(master)
        paths = [path for path, _ in items]
        leaves = [leaf for _, leaf in items]
        if cfg.microbatch > 1:
            n = cfg.microbatch
            grads = [torch.zeros_like(p, dtype=torch.float32,
                                      requires_grad=False) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in _split_microbatches(batch, n):
                (mb_loss, metrics), g = grad_of(leaves, paths, mb)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                loss = loss + mb_loss
            div = torch.full((), n, dtype=torch.float32, device=loss.device)
            for g in grads:
                g.div_(div)
            loss = loss / div
        else:
            (loss, metrics), grads = grad_of(leaves, paths, batch)
        lr = cosine_lr(state["opt"]["step"], peak=tc.peak_lr,
                       warmup=tc.warmup_steps, total=tc.total_steps)
        _, opt, gnorm = adamw_update(
            master, tree_from_items(zip(paths, grads)), state["opt"], lr,
            b1=tc.b1, b2=tc.b2, weight_decay=tc.weight_decay,
            grad_clip=tc.grad_clip)
        del grads
        new_state = {"params": master, "opt": opt,
                     "data_step": state["data_step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                           **metrics}

    return train_step


def jit_train_step(cfg: ModelConfig, rules=None,
                   tc: TrainConfig = TrainConfig()):
    """The production step: the JAX package jits and donates; the port
    runs :func:`make_train_step`'s step eagerly, updating in place."""
    return make_train_step(cfg, rules, tc)
