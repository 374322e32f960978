"""Device meshes of the port.  Twin of ``repro.launch.mesh``'s
``make_local_mesh``/``mesh_name`` and of ``repro._compat.make_mesh``.

A JAX mesh is an array of devices driven by one controller.  Here one
process drives one device, and the processes of a ``torch.distributed``
process group make up the mesh: rank ``r`` sits at the row-major
position ``r`` of the mesh's shape, as device ``r`` of a JAX mesh does.
A :class:`Mesh` carries the axis names, the shape, this rank's device
and the group; every collective of a mesh with a group goes through that
group, even at size 1.  A mesh without a group is one rank on its own.

``make_production_mesh`` and the dry-run wait for ROADMAP A13g.
"""
from __future__ import annotations

import dataclasses
import math
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
    def staged(self) -> bool:
        """True when collectives copy their buffers through host memory:
        a gloo group whose ranks compute on a card (NCCL takes one rank a
        card, so several ranks on one card share a gloo group; gloo's own
        CUDA paths stage through the host as well, and not all of its
        collectives take CUDA tensors)."""
        return (self.group is not None and self.device.type == "cuda"
                and dist.get_backend(self.group) == "gloo")


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
    if pod:
        return make_mesh((pod, n // (pod * model), model),
                         ("pod", "data", "model"), device=device)
    return make_mesh((n // model, model), ("data", "model"), device=device)


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.sizes)
