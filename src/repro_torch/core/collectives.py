"""The collectives of one SPMD body of ``core.distributed`` over named
mesh axes: the twins of ``jax.lax.all_gather(tiled=True)``,
``all_to_all(split_axis=0, concat_axis=0, tiled=True)``, ``psum``,
``pmax`` and ``axis_index`` inside a ``shard_map``, on
``torch.distributed``.

The axes must cover every mesh axis larger than 1: a body that runs
over a sub-mesh (replicated compute along the axes it leaves out) is
ROADMAP A9b.  A mesh without a process group is one rank, and every
collective is then the identity.  On a staged mesh (``Mesh.staged``)
each buffer goes to host memory and back around the collective.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch
import torch.distributed as dist

# ``all_gather_single`` is the newer name of ``all_gather_into_tensor``
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class Collectives:
    """Collectives over mesh axes ``axes`` of ``mesh``
    (``launch.mesh.Mesh``)."""

    def __init__(self, mesh, axes: Union[str, Sequence[str]]):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        shape = mesh.shape
        unknown = [a for a in axes if a not in shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not mesh axes "
                             f"{mesh.axis_names}")
        left = [a for a in mesh.axis_names if a not in axes and shape[a] > 1]
        if left:
            raise NotImplementedError(
                f"collectives over {axes} leave out mesh axes {left} of "
                "size > 1 (replicated compute over a sub-mesh); see "
                "ROADMAP.md queue A, item A9b")
        live = [a for a in axes if shape[a] > 1]
        if live != [a for a in mesh.axis_names if a in live]:
            raise NotImplementedError(
                f"axes {axes} list the mesh axes out of the mesh's order "
                f"{mesh.axis_names}; see ROADMAP.md queue A, item A9b")
        self.mesh = mesh
        self.axes = axes
        self.group = mesh.group
        #: shards along ``axes`` (the product of their sizes)
        self.size = math.prod(shape[a] for a in axes)

    def index(self) -> int:
        """This shard's linear index along the axes (``axis_index``)."""
        return self.mesh.rank

    def _run(self, fn, x: torch.Tensor, shape) -> torch.Tensor:
        """``fn(out, x)`` into a new ``shape`` buffer of ``x``'s dtype, on
        contiguous buffers, staged through host memory when the mesh
        asks for it."""
        x = x.contiguous()
        if not self.mesh.staged:
            out = x.new_empty(shape)
            fn(out, x)
            return out
        host = x.new_empty(shape, device="cpu")
        fn(host, x.cpu())
        return host.to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Blocks of every shard concatenated along dim 0, in shard
        order."""
        if self.group is None:
            return x
        return self._run(lambda o, i: _all_gather(o, i, group=self.group),
                         x, (self.size * x.shape[0],) + tuple(x.shape[1:]))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Split dim 0 into ``size`` equal blocks, send block j to shard j,
        and concatenate the received blocks along dim 0 in shard order."""
        if self.group is None:
            return x
        return self._run(lambda o, i: dist.all_to_all_single(
            o, i, group=self.group), x, x.shape)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return x

        def reduce(out, inp):
            out.copy_(inp)
            dist.all_reduce(out, op=op, group=self.group)
        return self._run(reduce, x, x.shape)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)
