"""Device meshes of the port.  Twin of ``repro.launch.mesh``'s
``make_local_mesh``/``mesh_name`` and of ``repro._compat.make_mesh``.

A JAX mesh is an array of devices driven by one controller.  Here one
process drives one device, and the processes of a ``torch.distributed``
process group make up the mesh: rank ``r`` sits at the row-major
position ``r`` of the mesh's shape, as device ``r`` of a JAX mesh does.
A :class:`Mesh` carries the axis names, the shape, this rank's device
and the group; a collective over the whole mesh goes through that group,
one over some of its axes (a sub-mesh, replicated along the axes it
leaves out) through one of the subgroups of :func:`axis_group`.  A mesh
without a group is one rank on its own.

:func:`init_distributed` joins the process group that ``torchrun``
describes in the environment, for the launchers' ``--model-shards``.

``make_production_mesh`` and the dry-run wait for ROADMAP A13g.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, this rank's device and its process group
    (``None``: a single rank, no communication)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, like a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def rank(self) -> int:
        """This process's row-major position in the mesh."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def coords(self) -> Tuple[int, ...]:
        """This rank's coordinate on every axis (row-major in ``rank``)."""
        return coords_of(self.rank, self.sizes)

    @property
    def staged(self) -> bool:
        """True when collectives copy their buffers through host memory:
        a gloo group whose ranks compute on a card (NCCL takes one rank a
        card, so several ranks on one card share a gloo group; gloo's own
        CUDA paths stage through the host as well, and not all of its
        collectives take CUDA tensors)."""
        return (self.group is not None and self.device.type == "cuda"
                and dist.get_backend(self.group) == "gloo")


def coords_of(rank: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    """The row-major coordinates of position ``rank`` in a mesh of
    ``sizes`` (the last axis fastest, as ``mesh.devices.flat``)."""
    out = []
    for n in reversed(tuple(sizes)):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


#: {(group, axis names, sizes): {axes: (subgroup, member mesh ranks)}}
_SUBGROUPS: dict = {}


def _global_rank(group, rank: int) -> int:
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def axis_group(mesh: Mesh, axes: Sequence[str]):
    """(process group, member mesh ranks) of the collectives over ``axes``
    (mesh axis names, any order) that this rank takes part in: the ranks
    that share its coordinates on every other axis.  The mesh's own group
    when they cover every axis larger than 1 (so every collective of a
    one-rank group goes through it); ``(None, [rank])`` when they hold
    one rank of a larger mesh, or the mesh has no group (one rank on its
    own, whatever its shape says).

    The first call for a mesh creates the subgroups of every sub-mesh,
    each row in row-major order, with ``dist.new_group``, which every
    rank of the world has to call in the same order; so every rank calls
    this (``Collectives``, ``sharding.MeshRules``) before the first
    collective, and none creates a group later."""
    names, sizes = mesh.axis_names, mesh.sizes
    live = [i for i, a in enumerate(names) if a in axes and sizes[i] > 1]
    if mesh.group is None:
        return None, [mesh.rank]
    if all(i in live for i, n in enumerate(sizes) if n > 1):
        return mesh.group, list(range(math.prod(sizes)))
    if not live:
        return None, [mesh.rank]
    return make_subgroups(mesh)[tuple(live)]


def make_subgroups(mesh: Mesh) -> dict:
    """Create (once) the subgroups of every sub-mesh of ``mesh`` (see
    :func:`axis_group`); every rank calls it at the same point."""
    if mesh.group is None:
        return {}
    key = (mesh.group, mesh.axis_names, mesh.sizes)
    if key not in _SUBGROUPS:
        _SUBGROUPS[key] = _make_subgroups(mesh)
    return _SUBGROUPS[key]


def _make_subgroups(mesh: Mesh) -> dict:
    """{live axis indices: (group, members)} for every proper sub-mesh of
    ``mesh`` with more than one rank (see :func:`axis_group`)."""
    sizes = mesh.sizes
    big = [i for i, n in enumerate(sizes) if n > 1]
    me = mesh.rank
    out = {}
    for r in range(1, len(big)):
        for live in itertools.combinations(big, r):
            rest = [i for i in range(len(sizes)) if i not in live]
            mine = None
            for fixed in itertools.product(*(range(sizes[i])
                                             for i in rest)):
                members = [p for p in range(math.prod(sizes))
                           if all(coords_of(p, sizes)[i] == c
                                  for i, c in zip(rest, fixed))]
                g = dist.new_group(
                    [_global_rank(mesh.group, p) for p in members])
                if me in members:
                    mine = (g, members)
            out[live] = mine
    return out


def make_mesh(shape: Sequence[int], names: Sequence[str], *, device=None,
              group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """A mesh of ``shape`` over ``group`` — by default the default process
    group when one is initialised, else a single rank with no group.
    ``device`` (default CUDA, raising without a card) is this rank's."""
    shape = tuple(int(s) for s in shape)
    names = tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ "
                         "in length")
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    ranks = 1 if group is None else dist.get_world_size(group)
    if math.prod(shape) != ranks:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks; the process group has {ranks}")
    return Mesh(names, shape, resolve_device(device), group)


def make_local_mesh(model: int = 1, pod: int = 0, *, device=None) -> Mesh:
    """Mesh over the ranks that exist (tests, examples, local runs):
    (data = ranks / model, model), or (pod, data, model) when pod > 0."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % (model * max(pod, 1)):
        raise ValueError(f"a mesh of {model} model shards"
                         + (f" and {pod} pods" if pod else "")
                         + f" needs a multiple of {model * max(pod, 1)} "
                         f"ranks, not {n} (several ranks: torchrun "
                         "--nproc-per-node N)")
    if pod:
        return make_mesh((pod, n // (pod * model), model),
                         ("pod", "data", "model"), device=device)
    return make_mesh((n // model, model), ("data", "model"), device=device)


def init_distributed(device: str = "cuda", *, timeout_s: float = 600.0):
    """Join the process group that ``torchrun`` describes (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and return
    this rank's device.  Without ``WORLD_SIZE`` > 1 nothing is joined and
    the device is :func:`~repro_torch.device.resolve_device`'s.

    On the card each rank takes ``cuda:LOCAL_RANK`` modulo the cards
    there are; NCCL when every rank has a card of its own, else a gloo
    group whose collectives stage through host memory (``Mesh.staged``).
    On the CPU: gloo."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = resolve_device(device)
    if world <= 1 or dist.is_initialized():
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    backend = "gloo"
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)
        if world <= n:
            backend = "nccl"
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.sizes)
