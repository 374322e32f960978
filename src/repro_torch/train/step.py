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
(the JAX step's ``_cast_with_grad_layout``).  The model's own
``.to(x.dtype)`` casts are then no-ops.  ``cfg.microbatch`` splits the
global batch (the gradients summed in microbatch order from zeros, then
divided).

Over a device mesh (``rules``) each rank holds its blocks of the state in
the layout of :func:`state_shardings` (ZeRO-1 when ``tc.zero1``: master
parameters, ``m`` and ``v`` sharded over the data axes too) and takes the
global batch.  The cast's forward all-gathers the master block over the
ZeRO-1 axes into the compute (tensor-parallel) layout; its backward sums
the cotangent over the batch's axes that the compute layout does not
shard (a rank's cotangent is the sum over its own rows only), keeps the
ZeRO-1 block (a reduce-scatter, or a ``psum`` without ZeRO-1) and then
rounds it through the wire dtype, as XLA orders the JAX step's convert
after its reduction: the port sums in float32, so ``grad_compress``
changes the numbers, not the bytes sent.  Under ``cfg.fsdp`` the ``embed`` width stays sharded over
``data`` in the compute layout and is gathered where the model uses it
(``models.lm``), whose backward reduce-scatters.  The AdamW update runs
on the blocks, with the global norm of ``optim.adamw_update``.  On a
``(1, 1)`` mesh the step is the one without a mesh, bit for bit.

Refused before the first step: the families A13d-f, and the kernel
switches (``attn_impl="pallas"``, ``use_pallas``): neither package has a
backward for those kernels.
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
from ..models.params import (from_jax_params, init_params, leaf_at,
                             param_shardings, tree_from_items, tree_items)
from ..sharding.rules import PartitionSpec, Sharding, comm_of
from .optim import adamw_init, adamw_update, cosine_lr, zero1_shardings


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
                     device=None, shardings=None) -> dict:
    """Master params (fp32, trainable) + AdamW moments + data cursor, on
    ``device`` (default: the card; ``generator`` lives there too).
    ``shardings`` (:func:`state_shardings`): this rank's blocks of the
    same draws."""
    params = init_params(get_model(cfg).param_defs(cfg), generator, dtype,
                         device, requires_grad=True,
                         shardings=None if shardings is None
                         else shardings["params"])
    return {"params": params, "opt": adamw_init(params),
            "data_step": torch.zeros((), dtype=torch.int32,
                                     device=resolve_device(device))}


def from_jax_state(state, device=None, shardings=None) -> dict:
    """A train state in the JAX package's layout (params, ``opt.m``,
    ``opt.v``, ``opt.step``, ``data_step``; arrays or anything
    ``np.asarray`` takes, such as a checkpoint restored without a device)
    as the port's, on ``device`` (default: the card).  ``shardings``
    (:func:`state_shardings`): every leaf this rank's block of the
    global one."""
    dev = resolve_device(device)
    sh = shardings or {"params": None, "opt": {"m": None, "v": None}}

    def moments(tree, shard):
        def one(path, a):
            a = np.asarray(a, np.float32)
            if shard is not None:
                a = leaf_at(shard, path).local(a)
            return torch.from_numpy(np.array(a)).to(dev)
        return tree_from_items((path, one(path, a))
                               for path, a in tree_items(tree))

    def i32(a):
        return torch.from_numpy(np.array(np.asarray(a, np.int32))).to(dev)
    return {"params": from_jax_params(state["params"], dev,
                                      requires_grad=True,
                                      shardings=sh["params"]),
            "opt": {"m": moments(state["opt"]["m"], sh["opt"]["m"]),
                    "v": moments(state["opt"]["v"], sh["opt"]["v"]),
                    "step": i32(state["opt"]["step"])},
            "data_step": i32(state["data_step"])}


def state_shardings(cfg: ModelConfig, rules,
                    tc: "TrainConfig" = None) -> dict:
    """Sharding tree matching ``init_train_state``'s structure: the
    ZeRO-1 layout when ``tc.zero1`` (the default), else the compute
    layout; the scalars replicated."""
    tc = TrainConfig() if tc is None else tc
    defs = get_model(cfg).param_defs(cfg)
    p_shard = (zero1_shardings(defs, rules) if tc.zero1
               else param_shardings(defs, rules))
    scalar = Sharding(rules.mesh, PartitionSpec())
    return {"params": p_shard,
            "opt": {"m": p_shard, "v": p_shard, "step": scalar},
            "data_step": scalar}


def state_structs(*args, **kwargs):
    raise not_ported("state_structs (the sharded dry-run state)", "A13g")


class _ComputeCast(torch.autograd.Function):
    """fp32 master leaf -> compute dtype; the cotangent comes back through
    ``wire`` (bfloat16 = gradient compression) as float32.  Over a mesh
    (``mesh``, a :class:`_LeafMesh`) the forward all-gathers the ZeRO-1
    block into the compute layout and the backward reduce-scatters the
    cotangent back (see the module's docstring)."""

    @staticmethod
    def forward(ctx, p, dtype, wire, mesh=None):
        ctx.wire, ctx.mesh = wire, mesh
        x = p.to(dtype) if p.dtype != dtype else p.view_as(p)
        if mesh is not None:
            for dim, comm in mesh.gathers:
                x = comm.all_gather(x, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        if mesh is not None:
            # the JAX step rounds the summed cotangent to ``wire`` (XLA
            # reduces the partial sums in float32, then converts), so the
            # sum comes first here too
            if mesh.reduce is not None:
                g = mesh.reduce.psum(g.to(torch.float32))
            for dim, comm in reversed(mesh.gathers):
                g = comm.local(g, dim)
            g = g.contiguous()
        return g.to(ctx.wire).to(torch.float32), None, None, None


class _LeafMesh:
    """One leaf's cast over a mesh: ``gathers`` ((dim, collectives) from
    the master to the compute layout) and ``reduce`` (the batch's axes
    over which its cotangent is partial: those the compute layout does
    not shard)."""

    def __init__(self, rules, compute: Sharding, master: Sharding,
                 batch_axes: tuple):
        self.gathers = []
        for dim in range(max(len(master.spec), len(compute.spec))):
            extra = tuple(a for a in master.spec.axes(dim)
                          if a not in compute.spec.axes(dim))
            if extra and master.blocks(dim) > compute.blocks(dim):
                self.gathers.append((dim, comm_of(rules.mesh, extra)))
        used = {a for d in range(len(compute.spec))
                for a in compute.spec.axes(d)}
        red = tuple(a for a in batch_axes if a not in used)
        c = comm_of(rules.mesh, red)
        self.reduce = c if c.size > 1 else None

    @property
    def trivial(self) -> bool:
        return not self.gathers and self.reduce is None


def check_trainable(cfg: ModelConfig) -> None:
    """Raise before the first step for what the port cannot train."""
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
    check_trainable(cfg)
    model = get_model(cfg)
    compute = compute_dtype(cfg)
    wire = torch.bfloat16 if tc.grad_compress else torch.float32
    layouts, owned, norm_comm = None, None, None
    if rules is not None:
        compute_sh = param_shardings(model.param_defs(cfg), rules)
        master_sh = tree_items(state_shardings(cfg, rules, tc)["params"])
        layouts = {path: (leaf_at(compute_sh, path), ms)
                   for path, ms in master_sh}
        owned = [ms.owner for _, ms in master_sh]
        norm_comm = comm_of(rules.mesh, rules.mesh.axis_names)

    def leaf_meshes(b: int) -> dict:
        """Each leaf's cast over the mesh for a microbatch of ``b``
        sequences (the batch's axes depend on ``b``)."""
        axes = rules.spec(("batch",), (b,)).axes(0)
        out = {}
        for path, (cs, ms) in layouts.items():
            lm = _LeafMesh(rules, cs, ms, axes)
            out[path] = None if lm.trivial else lm
        return out

    def grad_of(leaves, paths, mb, casts):
        cast = tree_from_items(
            (path, _ComputeCast.apply(p, compute, wire,
                                      None if casts is None
                                      else casts[path]))
            for path, p in zip(paths, leaves))
        loss, metrics = model.loss(cfg, cast, mb, rules)
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
        n = cfg.microbatch
        rows = len(next(iter(batch.values())))
        casts = None if rules is None else leaf_meshes(rows // n)
        if n > 1:
            grads = [torch.zeros_like(p, dtype=torch.float32,
                                      requires_grad=False) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb in _split_microbatches(batch, n):
                (mb_loss, metrics), g = grad_of(leaves, paths, mb, casts)
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                loss = loss + mb_loss
            div = torch.full((), n, dtype=torch.float32, device=loss.device)
            for g in grads:
                g.div_(div)
            loss = loss / div
        else:
            (loss, metrics), grads = grad_of(leaves, paths, batch, casts)
        lr = cosine_lr(state["opt"]["step"], peak=tc.peak_lr,
                       warmup=tc.warmup_steps, total=tc.total_steps)
        _, opt, gnorm = adamw_update(
            master, tree_from_items(zip(paths, grads)), state["opt"], lr,
            b1=tc.b1, b2=tc.b2, weight_decay=tc.weight_decay,
            grad_clip=tc.grad_clip, norm_comm=norm_comm, owned=owned)
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
