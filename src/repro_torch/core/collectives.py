"""Collectives over named mesh axes: the twins of
``jax.lax.all_gather(tiled=True)``, ``all_to_all(split_axis=0,
concat_axis=0, tiled=True)``, ``psum``, ``pmax`` and ``axis_index``
inside a ``shard_map``, on ``torch.distributed``; and ``reduce_scatter``
(``psum_scatter(tiled=True)``), which gloo lacks, as a ``psum`` followed
by this shard's slice.

The axes may leave out mesh axes: the collectives then run within each
row of the sub-mesh, among the ranks that share this rank's coordinates
on the axes left out (``launch.mesh.axis_group``), and the computation is
replicated along those axes, as in a JAX ``shard_map`` whose specs name
only some axes.  Shards are numbered row-major over ``axes`` in the order
given (``("pod", "data")``: pod major).  Axes that hold one rank (a mesh
without a process group, or axes of size 1) make every collective the
identity.  On a staged mesh (``Mesh.staged``) each buffer goes to host
memory and back around the collective.  On a dry mesh (``Mesh.dry``) a
collective sends nothing: it records its kind (JAX's spelling:
``all-gather``, ``all-to-all``, ``all-reduce``), operand and result
bytes and group size with the active dry trace (``device.dry_trace``),
and returns an empty buffer of the result's shape.  ``reduce_scatter`` is an
``all-reduce`` followed by this shard's slice here (gloo has no
reduce-scatter), and records as the ``all-reduce`` it sends.  The class
counters ``calls``/``bytes`` count dry and real calls alike.

The autograd functions at the end are the tensor- and data-parallel
model's (``models``, ``train``): :func:`copy_to` (identity forward,
``psum`` backward: Megatron's *f*, in front of a rank-local partial
computation on replicated inputs), :func:`reduce_from` (``psum``
forward, identity backward: Megatron's *g*, after it), and
:func:`gather_from` (all-gather forward, reduce-scatter backward: a
parameter sharded over the data axes gathered where it is used).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..device import dry_trace
from ..launch.mesh import axis_group, coords_of

# ``all_gather_single`` is the newer name of ``all_gather_into_tensor``
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class Collectives:
    """Collectives over mesh axes ``axes`` of ``mesh``
    (``launch.mesh.Mesh``)."""

    #: communicating calls and the bytes they sent, since the last reset
    #: (every instance; identity calls count nothing)
    calls = 0
    bytes = 0

    def __init__(self, mesh, axes: Union[str, Sequence[str]]):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        shape = mesh.shape
        unknown = [a for a in axes if a not in shape]
        if unknown:
            raise ValueError(f"axes {unknown} are not mesh axes "
                             f"{mesh.axis_names}")
        self.mesh = mesh
        self.axes = axes
        #: shards along ``axes`` (the product of their sizes)
        self.size = math.prod(shape[a] for a in axes)
        self.group, members = axis_group(mesh, axes)
        #: the shard index of each group rank (identity when ``axes``
        #: list the mesh axes in the mesh's order)
        order = [self._index_of(m) for m in members]
        self._order = None if order == list(range(len(order))) else order

    def _index_of(self, rank: int) -> int:
        c = dict(zip(self.mesh.axis_names,
                     coords_of(rank, self.mesh.sizes)))
        idx = 0
        for a in self.axes:
            idx = idx * self.mesh.shape[a] + c[a]
        return idx

    @classmethod
    def reset_counts(cls) -> None:
        cls.calls = 0
        cls.bytes = 0

    def index(self) -> int:
        """This shard's linear index along the axes (``axis_index``)."""
        return self._index_of(self.mesh.rank)

    def _run(self, kind: str, fn, x: torch.Tensor, shape) -> torch.Tensor:
        """``fn(out, x)`` into a new ``shape`` buffer of ``x``'s dtype, on
        contiguous buffers, staged through host memory when the mesh
        asks for it; on a dry mesh the ``kind`` of collective is recorded
        and ``fn`` not called."""
        x = x.contiguous()
        nbytes = x.numel() * x.element_size()
        Collectives.calls += 1
        Collectives.bytes += nbytes
        if self.mesh.dry:
            out = x.new_empty(shape)
            trace = dry_trace()
            if trace is not None:
                trace.collective(kind, nbytes,
                                 out.numel() * out.element_size(), self.size)
            return out
        if not self.mesh.staged:
            out = x.new_empty(shape)
            fn(out, x)
            return out
        host = x.new_empty(shape, device="cpu")
        fn(host, x.cpu())
        return host.to(x.device)

    def _blocks(self, x: torch.Tensor, order) -> torch.Tensor:
        """Dim 0 of ``x`` in ``size`` blocks, block ``order[j]`` at j."""
        return torch.cat([b for _, b in sorted(
            zip(order, x.chunk(self.size, 0)), key=lambda t: t[0])])

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Blocks of every shard concatenated along ``dim``, in shard
        order."""
        if self.group is None:
            return x
        if dim != 0:
            return self.all_gather(x.movedim(dim, 0), 0).movedim(0, dim)
        out = self._run("all-gather",
                        lambda o, i: _all_gather(o, i, group=self.group),
                        x, (self.size * x.shape[0],) + tuple(x.shape[1:]))
        return out if self._order is None else self._blocks(out,
                                                            self._order)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Split dim 0 into ``size`` equal blocks, send block j to shard j,
        and concatenate the received blocks along dim 0 in shard order."""
        if self.group is None:
            return x
        if self._order is not None:      # blocks to group-rank order
            inv = [0] * self.size
            for j, s in enumerate(self._order):
                inv[s] = j
            x = self._blocks(x, inv)
        out = self._run("all-to-all", lambda o, i: dist.all_to_all_single(
            o, i, group=self.group), x, x.shape)
        return out if self._order is None else self._blocks(out,
                                                            self._order)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return x

        def reduce(out, inp):
            out.copy_(inp)
            dist.all_reduce(out, op=op, group=self.group)
        return self._run("all-reduce", reduce, x, x.shape)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This shard's block of ``x`` along ``dim`` (a view)."""
        if self.size == 1:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index() * n, n)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum over the shards, this shard's block of it along
        ``dim``."""
        return self.local(self.psum(x), dim)


def _live(comm: Optional[Collectives]) -> bool:
    return comm is not None and comm.group is not None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.psum(g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.psum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, reduce):
        ctx.comm, ctx.dim, ctx.reduce = comm, dim, reduce
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if _live(ctx.reduce):
            g = ctx.reduce.psum(g)
        return ctx.comm.local(g, ctx.dim).contiguous(), None, None, None


def copy_to(comm: Optional[Collectives], x: torch.Tensor) -> torch.Tensor:
    """Identity; the cotangent is summed over ``comm``'s shards.  Put in
    front of a computation that each shard does on its own block of the
    weights (its cotangent is then a partial sum).  ``x`` itself when the
    axes hold one rank."""
    return _CopyTo.apply(x, comm) if _live(comm) else x


def reduce_from(comm: Optional[Collectives],
                x: torch.Tensor) -> torch.Tensor:
    """``psum`` over ``comm``'s shards; the cotangent passes unchanged
    (every shard holds the same, whole cotangent of the sum)."""
    return _ReduceFrom.apply(x, comm) if _live(comm) else x


def gather_from(comm: Optional[Collectives], x: torch.Tensor, dim: int,
                reduce: Optional[Collectives] = None) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``comm``; the cotangent is
    summed over ``reduce`` (the shards whose cotangents are partial:
    those of other data) and cut back to this shard's block."""
    return _GatherFrom.apply(x, comm, dim, reduce) if _live(comm) else x
