"""Logical-axis → mesh-axis sharding rules (DESIGN.md §6).  Port of
``repro.sharding.rules``.

Every parameter and activation of the model declares *logical* axis
names; ``MeshRules`` resolves them against a mesh (``launch.mesh.Mesh``)
with the JAX package's divisibility fallback: a dimension that does not
divide by its mesh axes is left unsharded and recorded in ``fallbacks``
(granite-moe-3b-a800m's vocab of 49,155 divides by nothing, so its
``embed`` is replicated over ``model``).

Default table:
  batch            -> ("pod", "data")     data parallel
  heads/vocab/ff/
  moe_ff/ssm_heads -> "model"             tensor parallel (Megatron splits)
  kv_seq           -> "model"             sequence-parallel decode caches
  embed            -> "data" iff fsdp     ZeRO-3-style parameter sharding
  everything else  -> replicated

JAX's ``NamedSharding`` lays an array out over the devices and GSPMD
partitions the program.  The port has no partitioner: a
:class:`Sharding` says which block of a global tensor each rank holds
(:meth:`Sharding.local`), and gathers the blocks back
(:meth:`Sharding.gather`); the model computes on its blocks and issues
the collectives GSPMD would insert (``models.common``, ``models.lm``,
``train.step``).  A rank's block along a dimension sharded over several
axes (``("pod", "data")``) is numbered row-major over those axes, from
the rank's row-major coordinates in the mesh, as a JAX mesh numbers the
device at ``mesh.devices.flat[r]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.collectives import Collectives
from ..launch.mesh import Mesh, coords_of, make_subgroups

# logical axis -> tuple of candidate mesh axes (joined)
DEFAULT_TABLE: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model",),
    "ff": ("model",),
    "moe_ff": ("model",),
    "ssm_heads": ("model",),
    "ssm_inner": ("model",),
    "kv_seq": ("model",),
    "long_seq": ("data", "model"),   # batch=1 long-context states
    "experts": (),                   # EP disabled by default (see DESIGN §6)
    "embed": (),                     # becomes ("data",) under fsdp
    "seq": (),
    "layers": (),
}


class PartitionSpec(tuple):
    """Per dimension ``None`` (replicated), a mesh axis name, or a tuple
    of names (joined, the first major); trailing ``None``s stripped, as
    ``jax.sharding.PartitionSpec``'s entries."""

    def __new__(cls, *entries):
        entries = list(entries)
        while entries and entries[-1] is None:
            entries.pop()
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"

    def axes(self, dim: int) -> tuple:
        """The mesh axes of dimension ``dim`` (``()``: replicated)."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e if isinstance(e, tuple) else (e,))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A global tensor's layout over ``mesh``: each dimension in equal
    blocks over the axes of ``spec``'s entry (the twin of
    ``NamedSharding``)."""
    mesh: Mesh
    spec: PartitionSpec

    def blocks(self, dim: int) -> int:
        shape = self.mesh.shape
        return math.prod(shape[a] for a in self.spec.axes(dim))

    def comm(self, dim: int) -> Collectives:
        """The collectives over dimension ``dim``'s axes."""
        return comm_of(self.mesh, self.spec.axes(dim))

    def local_shape(self, shape: Sequence[int]) -> tuple:
        return tuple(n // self.blocks(i) for i, n in enumerate(shape))

    def local(self, t):
        """This rank's block of the global ``t`` (a tensor or a numpy
        array; a view of it)."""
        if t.ndim == 0:
            return t
        idx = []
        for i in range(t.ndim):
            n = self.blocks(i)
            b = self.comm(i).index() if n > 1 else 0
            size = t.shape[i] // n
            if t.shape[i] % n:
                raise ValueError(f"dimension {i} of {tuple(t.shape)} does "
                                 f"not divide into {n} blocks ({self.spec})")
            idx.append(slice(b * size, (b + 1) * size))
        return t[tuple(idx)]

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block (a collective: every
        rank of the mesh calls it)."""
        for i in range(block.dim()):
            if self.blocks(i) > 1:
                block = self.comm(i).all_gather(block, i)
        return block

    def gather_host(self, block: torch.Tensor) -> Optional[np.ndarray]:
        """The global array in host memory on mesh rank 0, ``None`` on the
        others (a collective: every rank of the mesh calls it).  Every
        rank sends its block to rank 0 alone, through host memory on a
        gloo group: a checkpoint's gather, a quarter of
        :meth:`gather`'s traffic at four ranks."""
        mesh = self.mesh
        if mesh.group is None or not any(self.blocks(i) > 1
                                         for i in range(block.dim())):
            return block.detach().cpu().numpy() if mesh.rank == 0 else None
        n = math.prod(mesh.sizes)
        host = dist.get_backend(mesh.group) == "gloo"
        x = block.detach().contiguous()
        x = x.cpu() if host else x
        got = [torch.empty_like(x) for _ in range(n)] if mesh.rank == 0 \
            else None
        dist.gather(x, got, dst=dist.get_global_rank(mesh.group, 0)
                    if mesh.group is not dist.group.WORLD else 0,
                    group=mesh.group)
        if mesh.rank != 0:
            return None
        out = np.empty(tuple(n_ * self.blocks(i)
                             for i, n_ in enumerate(x.shape)),
                       dtype=got[0].cpu().numpy().dtype)
        for r, b in enumerate(got):
            c = dict(zip(mesh.axis_names, coords_of(r, mesh.sizes)))
            idx = []
            for i, n_ in enumerate(x.shape):
                k = 0
                for a in self.spec.axes(i):
                    k = k * mesh.shape[a] + c[a]
                idx.append(slice(k * n_, (k + 1) * n_))
            out[tuple(idx)] = b.cpu().numpy()
        return out

    @property
    def replicas(self) -> list:
        """The mesh axes that hold copies of the same block."""
        used = {a for i in range(len(self.spec)) for a in self.spec.axes(i)}
        return [a for a in self.mesh.axis_names if a not in used]

    @property
    def owner(self) -> bool:
        """Whether this rank holds the first copy of its block (each block
        counted once in a sum over the mesh)."""
        c = dict(zip(self.mesh.axis_names, self.mesh.coords))
        return all(c[a] == 0 for a in self.replicas)


#: {(mesh, axes): Collectives}
_COMMS: dict = {}


def comm_of(mesh: Mesh, axes: Sequence[str]) -> Collectives:
    """The (cached) collectives over ``axes`` of ``mesh``."""
    key = (mesh, tuple(axes))
    if key not in _COMMS:
        _COMMS[key] = Collectives(mesh, tuple(axes))
    return _COMMS[key]


@dataclasses.dataclass
class MeshRules:
    mesh: Mesh
    table: dict = None
    fsdp: bool = False
    fallbacks: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.table is None:
            self.table = dict(DEFAULT_TABLE)
        if self.fsdp:
            self.table = {**self.table, "embed": ("data",)}
        self._axis_sizes = dict(self.mesh.shape)
        # every rank creates the mesh's subgroups here, before the first
        # collective (``launch.mesh.axis_group``)
        make_subgroups(self.mesh)
        #: per-call layouts of the model (``models.layout``), by key
        self.layouts: dict = {}

    def _mesh_axes_for(self, logical: Optional[str]) -> tuple[str, ...]:
        if logical is None:
            return ()
        axes = self.table.get(logical, ())
        return tuple(a for a in axes if a in self._axis_sizes)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
        """PartitionSpec for dims named by logical axes; if ``shape`` is
        given, non-dividing assignments fall back to replication."""
        entries, used = [], set()
        for i, name in enumerate(logical_axes):
            axes = self._mesh_axes_for(name)
            axes = tuple(a for a in axes if a not in used)
            if shape is not None and axes:
                div = int(np.prod([self._axis_sizes[a] for a in axes]))
                if shape[i] % div != 0:
                    # try progressively shorter prefixes of the axis tuple
                    while axes:
                        axes = axes[:-1]
                        div = int(np.prod([self._axis_sizes[a]
                                           for a in axes])) if axes else 1
                        if axes and shape[i] % div == 0:
                            break
                    if not axes:
                        self.fallbacks.append((tuple(logical_axes), i, name))
            used.update(axes)
            if not axes:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(tuple(axes))
        return PartitionSpec(*entries)

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> Sharding:
        return Sharding(self.mesh, self.spec(logical_axes, shape))

    def constrain(self, x: torch.Tensor, *logical_axes,
                  shape: Sequence[int]):
        """The twin of ``with_sharding_constraint`` by logical axes: ``x``
        must be this rank's block of a tensor of global ``shape`` laid out
        by ``logical_axes``; returns ``x``.  Where GSPMD would reshard at
        such a hint, the port's model issues the collective itself."""
        want = self.sharding(logical_axes, shape).local_shape(shape)
        if tuple(x.shape) != want:
            raise ValueError(f"block {tuple(x.shape)} is not this rank's "
                             f"block {want} of {tuple(shape)} over "
                             f"{logical_axes}")
        return x

    def comm(self, axes: Sequence[str]) -> Collectives:
        return comm_of(self.mesh, axes)

    @property
    def data_size(self) -> int:
        return int(np.prod([self._axis_sizes.get(a, 1)
                            for a in ("pod", "data")]))

    @property
    def model_size(self) -> int:
        return self._axis_sizes.get("model", 1)


def logical_spec(*names: Optional[str]) -> tuple:
    """Convenience: declare logical axes of a tensor."""
    return tuple(names)
