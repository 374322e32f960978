"""Dry-trace profiler: the port's twin of ``repro.analysis.hlo``.

The JAX package lowers and compiles a step for placeholder devices and
walks the per-device HLO.  The port has no compiler between its Python
and the card: a step is the sequence of ATen ops it dispatches.  A
:class:`Trace` runs one rank's call on the ``meta`` device (no card, no
allocation) under a ``TorchDispatchMode`` and counts, per rank:

1. FLOPs.  ``mm``/``bmm``/``addmm``/``baddbmm``/convolution/SDPA count
   2·M·N·K, exactly as ``torch.utils.flop_counter.FlopCounterMode``
   counts them (its formulas, and its decomposition of ops it has none
   for): these are ``tensor_flops``, the twin of HLO's ``mxu_flops``.
   The elementwise ops of ``hlo._EW_OPS`` count one per element.  A
   kernel counts its ``work`` (each kernel module's ``work``): the dry
   trace resolves kernels as the card does (``device.on_card``) and
   calls their meta functions (``kernels.ops``), never their plain
   versions.
2. HBM traffic: each dispatched op counts the bytes of its distinct
   operands plus its results.  Views and the counterparts of
   ``hlo._FREE_OPS`` (allocations, ``arange``, aliases) count nothing,
   nor does an output that aliases an input (an in-place op; an op that
   only returns an alias, such as ``_unsafe_view``, counts nothing at
   all).  A gather
   (``index``, ``embedding``, ...) reads what it returns, not its whole
   source, and a scatter into a buffer (``index_put_``, ...) writes its
   values' rows, not the whole buffer (``hlo``'s slice reads and in-place
   ``dynamic-update-slice``).  The
   eager port runs every op as its own kernel, so this is its real,
   unfused traffic, not XLA's fused estimate; a kernel counts its
   ``work`` bytes.
3. Peak memory: the largest sum of live storages (storages, not views,
   so a view adds nothing; autograd's saved tensors are live and
   count), from the call's arguments on.
4. Collectives: those the dry mesh records at
   ``core.collectives.Collectives._run``,
   with ``Collective.wire_bytes``'s ring formula (copied from
   ``repro.analysis.hlo``).

:func:`trace` returns an :class:`Artifact`: the profile, the bytes of
the call's arguments (this rank's parameters, state, cache and inputs),
of its outputs, and the peak.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Callable, Dict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .. import device as _device

aten = torch.ops.aten

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

#: The twins of ``hlo._EW_OPS``: one flop an element of the result.
_EW_NAMES = ("add", "sub", "rsub", "mul", "div", "maximum", "minimum",
             "exp", "tanh", "log", "rsqrt", "sqrt", "pow", "neg", "abs",
             "cos", "sin", "sigmoid", "remainder", "atan2", "expm1",
             "log1p", "erf")
_EW_OPS = {getattr(aten, n) for n in _EW_NAMES} | {
    getattr(aten, n + "_") for n in _EW_NAMES if hasattr(aten, n + "_")}

#: The twins of ``hlo._FREE_OPS``: no HBM traffic (allocations, aliases,
#: ``arange`` (iota), metadata).
_FREE_OPS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
             aten.new_empty_strided, aten.arange, aten.detach, aten.alias,
             aten.lift_fresh, aten.lift_fresh_copy, aten._local_scalar_dense,
             aten.set_}

#: Ops that read only the rows they return from their first operand.
_GATHER_OPS = {aten.index, aten.index_select, aten.embedding, aten.gather,
               aten.take}
#: Ops that write only their values' rows into their first operand.
_SCATTER_OPS = {aten.index_put, aten.index_put_, aten._index_put_impl_,
                aten.index_add, aten.index_add_, aten.scatter,
                aten.scatter_, aten.scatter_add, aten.scatter_add_,
                aten.index_copy, aten.index_copy_}

#: Metadata queries the dispatcher may route here: not ops.
_SKIP = {aten.sym_size.default, aten.sym_stride.default, aten.size.default,
         aten.stride.default, aten.dim.default, aten.numel.default,
         aten.sym_numel.default, aten.is_contiguous.default,
         aten.is_contiguous.memory_format, aten.storage_offset.default,
         aten.sym_storage_offset.default,
         aten.is_strides_like_format.default,
         aten.is_non_overlapping_and_dense.default,
         torch.ops.prim.layout.default}

_FLOP_REGISTRY = FlopCounterMode().flop_registry

#: Ops whose ``decompose`` gave nothing (no CompositeImplicit kernel):
#: not asked again.
_NO_DECOMPOSITION: set = set()


@dataclasses.dataclass
class Collective:
    kind: str
    operand_bytes: int     # per-rank bytes sent into the collective
    result_bytes: int
    group_size: int
    computation: str = ""
    mult: float = 1.0

    @property
    def wire_bytes(self) -> int:
        """Ring-algorithm per-device traffic estimate (one occurrence)."""
        n = max(self.group_size, 1)
        if n == 1:
            return 0
        b = self.operand_bytes
        if self.kind == "all-gather":
            return b * (n - 1)
        if self.kind == "all-reduce":
            return int(2 * b * (n - 1) / n)
        if self.kind in ("reduce-scatter", "all-to-all"):
            return int(b * (n - 1) / n)
        return b  # collective-permute


def _kind_rows(by_kind: dict) -> str:
    rows = [f"  {k:<19} n={int(c):<6} operand={ob / 1e6:10.2f}MB "
            f"wire={wb / 1e6:10.2f}MB"
            for k, (c, ob, wb) in sorted(by_kind.items())]
    return "\n".join(rows) if rows else "  (no collectives)"


@dataclasses.dataclass
class CollectiveStats:
    collectives: list
    operand_bytes: int
    wire_bytes: int
    by_kind: dict

    def summary(self) -> str:
        return _kind_rows(self.by_kind)


@dataclasses.dataclass
class OpsProfile:
    flops: float                # every counted flop (incl. elementwise)
    tensor_flops: float         # products (mm, bmm, conv, SDPA, kernels')
    traffic_bytes: float        # unfused per-op HBM traffic
    operand_bytes: float        # Σ collective operand sizes
    wire_bytes: float           # ring-estimate collective traffic
    by_kind: dict               # kind -> (count, operand_bytes, wire_bytes)
    collectives: list
    kernels: dict               # kernel -> (calls, bytes, operations)
    n_ops: int = 0              # dispatched ops

    def summary(self) -> str:
        return _kind_rows(self.by_kind)

    def stats(self) -> CollectiveStats:
        return CollectiveStats(self.collectives, int(self.operand_bytes),
                               int(self.wire_bytes), self.by_kind)

    def kernel_calls(self) -> Dict[str, int]:
        return {k: int(v[0]) for k, v in self.kernels.items()}


@dataclasses.dataclass
class Artifact:
    """One traced call: its profile, the bytes of its arguments (this
    rank's tensors passed in), of its outputs and the peak of live
    storages; ``out``, what the call returned (``meta`` tensors)."""
    profile: OpsProfile
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    out: Any = None

    @property
    def temp_bytes(self) -> int:
        return max(self.peak_bytes - self.argument_bytes, 0)


def _tensors(tree) -> list:
    """Every tensor of a nested structure (dicts, lists, tuples,
    ``nn.ParameterDict``s)."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (dict, torch.nn.ParameterDict)):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
    walk(tree)
    return out


def _flat(x, out: list) -> list:
    """The tensors of an op's arguments or results (nested lists and
    tuples)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _flat(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, out)
    return out


def _storage(t: torch.Tensor):
    st = t.untyped_storage()
    return st._cdata, st


def _extent(t: torch.Tensor) -> int:
    """Bytes of ``t``'s own elements (a broadcast dimension once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in _tensors(tree):
        key, st = _storage(t)
        seen[key] = st.nbytes()
    return sum(seen.values())


def _indexed_bytes(packet, args, outs) -> int:
    """A gather's or a scatter's traffic: its indices, and the rows it
    moves read once and written once (a gather's result; a scatter's
    values, or the rows of its source it adds)."""
    rest = _flat(list(args[1:]), [])
    if packet in _GATHER_OPS:
        moved = sum(_extent(t) for t in outs)
        return moved + sum(_extent(t) for t in rest) + moved
    vals = [t for t in rest if t.is_floating_point() or t.dtype.is_complex
            or t.dtype == args[0].dtype]
    moved = sum(_extent(t) for t in vals) if vals else sum(
        _extent(t) for t in outs)
    return sum(_extent(t) for t in rest) + moved


class _Live:
    """Live storages: bytes by weak reference, swept only where a new
    peak could be set."""

    def __init__(self):
        self.refs: Dict[int, tuple] = {}
        self.upper = 0          # live bytes, counting some freed
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        key, st = _storage(t)
        old = self.refs.get(key)
        if old is not None and not old[0].expired():
            return
        n = st.nbytes()
        self.refs[key] = (StorageWeakRef(st), n)
        self.upper += n
        if self.upper > self.peak:
            self.sweep()
            self.peak = max(self.peak, self.upper)

    def sweep(self) -> None:
        dead = [k for k, (ref, _) in self.refs.items() if ref.expired()]
        for k in dead:
            self.upper -= self.refs.pop(k)[1]


class Trace:
    """The dry trace of the ops run inside the block (see the module's
    docstring); :meth:`profile` is what it counted."""

    def __init__(self):
        self.flops = 0.0
        self.tensor_flops = 0.0
        self.traffic = 0.0
        self.n_ops = 0
        self.kernels: Dict[str, list] = defaultdict(lambda: [0, 0, 0])
        self.live = _Live()
        self._colls: list = []

    # -- recording (``device.record_kernel``, ``Collectives._run``) -------
    def kernel(self, name: str, nbytes: int, ops: int,
               tensor: bool) -> None:
        k = self.kernels[name]
        k[0] += 1
        k[1] += nbytes
        k[2] += ops
        self.traffic += nbytes
        self.flops += ops
        if tensor:
            self.tensor_flops += ops

    def collective(self, kind: str, operand_bytes: int, result_bytes: int,
                   group_size: int) -> None:
        self._colls.append(Collective(kind, operand_bytes, result_bytes,
                                      group_size))

    def hold(self, tree) -> None:
        """Count the storages of ``tree`` as live (the call's
        arguments)."""
        for t in _tensors(tree):
            self.live.add(t)

    def __enter__(self):
        self._prev = _device.set_dry_trace(self)
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            _device.set_dry_trace(self._prev)
        return False

    def _count(self, func, args, kwargs, out) -> None:
        self.n_ops += 1
        packet = func._overloadpacket
        outs = _flat(out, [])
        if func in _FLOP_REGISTRY or packet in _FLOP_REGISTRY:
            f = _FLOP_REGISTRY[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.tensor_flops += f
        elif packet in _EW_OPS:
            self.flops += sum(t.numel() for t in outs)
        for t in outs:
            self.live.add(t)
        if packet in _FREE_OPS or func.is_view:
            return
        if packet in _GATHER_OPS or packet in _SCATTER_OPS:
            self.traffic += _indexed_bytes(packet, args, outs)
            return
        ins = _flat(kwargs, _flat(args, []))
        seen, in_keys, nbytes = set(), set(), 0
        for t in ins:
            key = (_storage(t)[0], t.storage_offset(), tuple(t.shape),
                   tuple(t.stride()))
            in_keys.add(key[0])
            if key not in seen:
                seen.add(key)
                nbytes += _extent(t)
        fresh = [t for t in outs if _storage(t)[0] not in in_keys]
        if outs and not fresh and not func._schema.is_mutable:
            return              # a view by another name (``_unsafe_view``)
        self.traffic += nbytes + sum(_extent(t) for t in fresh)

    # -- result -----------------------------------------------------------
    def profile(self) -> OpsProfile:
        colls = self._colls
        by_kind: dict = defaultdict(lambda: [0, 0, 0])
        tot_ob = tot_wb = 0
        for c in colls:
            e = by_kind[c.kind]
            e[0] += c.mult
            e[1] += c.operand_bytes * c.mult
            e[2] += c.wire_bytes * c.mult
            tot_ob += c.operand_bytes * c.mult
            tot_wb += c.wire_bytes * c.mult
        return OpsProfile(
            self.flops, self.tensor_flops, self.traffic, tot_ob, tot_wb,
            {k: tuple(v) for k, v in by_kind.items()}, colls,
            {k: tuple(v) for k, v in self.kernels.items()}, self.n_ops)


class _Mode(TorchDispatchMode):
    """The dispatch mode of a :class:`Trace`: every op is counted where
    ``FlopCounterMode`` would count it."""

    def __init__(self, tr: Trace):
        super().__init__()
        self.tr = tr

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SKIP:
            return func(*args, **kwargs)
        if func not in _FLOP_REGISTRY and func not in _NO_DECOMPOSITION \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
            _NO_DECOMPOSITION.add(func)
        out = func(*args, **kwargs)
        self.tr._count(func, args, kwargs, out)
        return out


def trace(fn: Callable, *args, **kwargs) -> Artifact:
    """Run ``fn(*args, **kwargs)`` (``meta`` tensors, and a dry mesh
    where it takes one) under a :class:`Trace`; the arguments' storages
    are live from the start."""
    tr = Trace()
    arg_bytes = storage_bytes((args, kwargs))
    with tr:
        tr.hold((args, kwargs))
        out = fn(*args, **kwargs)
    tr.live.sweep()
    prof = tr.profile()
    return Artifact(prof, arg_bytes, storage_bytes(out),
                    max(tr.live.peak, arg_bytes), out)


def profile_call(fn: Callable, *args, **kwargs) -> OpsProfile:
    """The :class:`OpsProfile` of one traced call."""
    return trace(fn, *args, **kwargs).profile


def parse_collectives(artifact: Artifact) -> CollectiveStats:
    """The collectives of a traced call (``hlo.parse_collectives``'s
    twin)."""
    return artifact.profile.stats()
