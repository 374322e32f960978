"""Parameter declaration machinery.  Port of ``repro.models.params``.

Each model family declares its parameters once as a nested dict of
``ParamDef`` (shape + logical axes + init); from that single table come
initialisation and parameter counts.  The parameter tree itself is an
``nn.Module`` of nested ``nn.ParameterDict``s (:class:`ParamTree`): its
``state_dict()`` keys are the JAX tree paths joined by ``.``, and stacked
layer tensors keep their leading ``(n_layers, ...)`` axis.  Parameters are
frozen (``requires_grad=False``) by default, as serving and routing want
them; ``requires_grad=True`` builds a trainable tree (the training slice,
``repro_torch.train``).

Over a device mesh (``sharding.MeshRules``) ``param_specs`` and
``param_shardings`` give each leaf's layout, and ``init_params`` and
``from_jax_params`` give each rank its blocks (``Sharding.local``).
``param_structs`` gives the dry run's stand-ins (:class:`Struct`: the
twin of ``jax.ShapeDtypeStruct``), whose :meth:`Struct.local` is this
rank's block on the ``meta`` device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


class ParamDef(NamedTuple):
    shape: tuple
    axes: tuple                  # logical axis names (len == len(shape))
    init: str = "normal"         # normal | zeros | ones
    scale: Optional[float] = None  # None -> 1/sqrt(shape[-2] or [-1])


def _is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _is_node(x) -> bool:
    """An inner node of a parameter tree: a dict or a ``ParamTree``."""
    return isinstance(x, (Mapping, nn.ParameterDict))


def map_defs(fn, defs):
    """Map a function over every ParamDef leaf of a nested dict."""
    if _is_def(defs):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def count_params(defs) -> int:
    total = 0

    def add(d):
        nonlocal total
        total += int(np.prod(d.shape))
        return d

    map_defs(add, defs)
    return total


class ParamTree(nn.ParameterDict):
    """A nested parameter tree: ``tree["layers"]["attn"]["wq"]``.

    Inner nodes are ``ParamTree``s (registered as submodules), leaves are
    ``nn.Parameter``s (frozen unless ``requires_grad``), so
    ``state_dict()`` keys read ``"layers.attn.wq"``."""

    @classmethod
    def from_tensors(cls, tree: Mapping,
                     requires_grad: bool = False) -> "ParamTree":
        out = cls()
        for k in sorted(tree):
            v = tree[k]
            out[k] = (cls.from_tensors(v, requires_grad) if _is_node(v)
                      else nn.Parameter(v, requires_grad=requires_grad))
        return out


def param_specs(defs, rules):
    """PartitionSpec tree matching the parameter tree structure."""
    return map_defs(lambda d: rules.spec(d.axes, d.shape), defs)


def param_shardings(defs, rules):
    """``sharding.Sharding`` tree matching the parameter tree structure."""
    return map_defs(lambda d: rules.sharding(d.axes, d.shape), defs)


@dataclasses.dataclass(frozen=True)
class Struct:
    """A dry-run stand-in: a global ``shape`` and ``dtype`` laid out by
    ``sharding`` (``sharding.Sharding``; ``None``: whole on every rank),
    the twin of ``jax.ShapeDtypeStruct``.  ``value``: a leaf the step
    reads on the host (the decode cache's ``pos``) is a real CPU tensor
    filled with it."""
    shape: tuple
    dtype: torch.dtype
    sharding: Any = None
    value: Optional[float] = None

    def local_shape(self) -> tuple:
        if self.sharding is None:
            return tuple(self.shape)
        return self.sharding.local_shape(self.shape)

    @property
    def nbytes(self) -> int:
        """Bytes of this rank's block."""
        return math.prod(self.local_shape()) * torch.empty(
            (), dtype=self.dtype).element_size()

    def local(self) -> torch.Tensor:
        """This rank's block: empty on ``meta``, or filled with ``value``
        on the CPU."""
        return self._make(self.local_shape())

    def whole(self) -> torch.Tensor:
        """The global tensor, as :meth:`local` makes a block: what every
        rank passes where the port's entries take the global batch."""
        return self._make(tuple(self.shape))

    def _make(self, shape) -> torch.Tensor:
        if self.value is not None:
            return torch.full(shape, self.value, dtype=self.dtype)
        return torch.empty(shape, dtype=self.dtype, device="meta")


def param_structs(defs, rules=None, dtype: torch.dtype = torch.float32):
    """:class:`Struct` tree of the parameters (dry-run stand-ins; no
    allocation), laid out by ``rules`` when given."""
    if rules is None:
        return map_defs(lambda d: Struct(tuple(d.shape), dtype), defs)
    return map_defs(lambda d: Struct(tuple(d.shape), dtype,
                                     rules.sharding(d.axes, d.shape)), defs)


def struct_locals(tree):
    """This rank's blocks of a tree of :class:`Struct` (nested dicts),
    with the tree's structure; other leaves pass as they are."""
    if isinstance(tree, Struct):
        return tree.local()
    if isinstance(tree, Mapping):
        return {k: struct_locals(v) for k, v in tree.items()}
    return tree


def leaf_at(tree, path):
    """The node of ``tree`` at ``path`` (a tuple of keys)."""
    for k in path:
        tree = tree[k]
    return tree


def _block(t: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of ``t`` as a tensor of its own (no view keeping
    the whole alive)."""
    if sharding is None:
        return t
    b = sharding.local(t)
    return b if b.shape == t.shape else b.clone()


def init_params(defs, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device=None, requires_grad: bool = False, rules=None,
                shardings=None) -> ParamTree:
    """Initialise a parameter tree from its declaration (deterministic).

    The same per-leaf distributions and scales as the JAX package: N(0, 1)
    times ``scale`` (default ``1/sqrt(shape[-2])``, ``1/sqrt(shape[-1])``
    for vectors), zeros or ones; leaves are drawn in sorted path order
    from ``generator``, which must live on ``device`` (default: the card,
    see :func:`repro_torch.device.resolve_device`; pass ``device="cpu"``
    with a CPU generator to run on the CPU).  The draws differ from
    ``jax.random``'s; tests that compare the packages convert one tree
    with :func:`from_jax_params`.  ``requires_grad=True``: a trainable
    tree.

    Over a mesh (``rules``, or a ``shardings`` tree such as the ZeRO-1
    layout): every rank draws every leaf whole, as without one, and keeps
    its block at once, so no rank holds more than one whole leaf."""
    device = resolve_device(device)
    if shardings is None and rules is not None:
        shardings = param_shardings(defs, rules)
    if torch.device(generator.device).type != device.type:
        raise ValueError(f"generator on {generator.device} cannot draw "
                         f"parameters on {device}")
    leaves = []

    def collect(d, path):
        if _is_def(d):
            leaves.append((path, d))
        else:
            for k in sorted(d):
                collect(d[k], path + (k,))

    collect(defs, ())
    out = []
    for path, d in leaves:
        if d.init == "zeros":
            arr = torch.zeros(d.shape, dtype=dtype, device=device)
        elif d.init == "ones":
            arr = torch.ones(d.shape, dtype=dtype, device=device)
        else:
            scale = d.scale if d.scale is not None else 1.0 / math.sqrt(
                max(d.shape[-2] if len(d.shape) >= 2 else d.shape[-1], 1))
            arr = torch.randn(d.shape, generator=generator,
                              dtype=torch.float32, device=device)
            arr = arr.mul_(scale).to(dtype)
        if shardings is not None:
            arr = _block(arr, leaf_at(shardings, path))
        out.append((path, arr))
    return ParamTree.from_tensors(tree_from_items(out), requires_grad)


def from_jax_params(tree: Mapping, device=None,
                    dtype: Optional[torch.dtype] = None,
                    requires_grad: bool = False,
                    shardings=None) -> ParamTree:
    """The JAX package's parameter tree (nested dict of arrays; anything
    ``np.asarray`` takes) as a :class:`ParamTree` on ``device`` (default:
    the card, as :func:`init_params`), in ``dtype`` (default float32, the
    JAX package's parameter type).  The parity tests use it so that both
    packages compute with the same weights.  ``requires_grad=True``: a
    trainable tree.  ``shardings`` (a tree of ``sharding.Sharding``, e.g.
    ``param_shardings(defs, rules)``): each leaf is this rank's block of
    the global one."""
    device = resolve_device(device)

    def convert(node, sh):
        if _is_node(node):
            return {k: convert(v, None if sh is None else sh[k])
                    for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if sh is not None:
            a = sh.local(a)
        t = torch.from_numpy(np.array(a))
        return t.to(device=device, dtype=dtype or torch.float32)
    return ParamTree.from_tensors(convert(tree, shardings), requires_grad)


def tree_items(tree, prefix: tuple = ()) -> list:
    """``[(path, leaf), ...]`` of a nested tree (dicts, ``ParamTree``s) in
    ``jax.tree.leaves`` order: keys sorted at every level."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree.keys()):
        out.extend(tree_items(tree[k], prefix + (k,)))
    return out


def tree_map(fn, tree):
    """A nested dict of ``fn(leaf)`` with ``tree``'s structure."""
    if not _is_node(tree):
        return fn(tree)
    return {k: tree_map(fn, tree[k]) for k in sorted(tree.keys())}


def tree_from_items(items) -> dict:
    """The nested dict of ``[(path, leaf), ...]`` (:func:`tree_items`)."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def layer_slice(tree: Mapping, i: int) -> dict:
    """Layer ``i`` of a stacked parameter subtree (the leading axis), as a
    nested dict of views: the twin of ``jax.tree.map(lambda a: a[i], t)``.
    For prefill and decode; ``forward`` takes :func:`layer_views`."""
    return {k: (layer_slice(v, i) if _is_node(v) else v[i])
            for k, v in tree.items()}


def layer_views(tree: Mapping, n: int) -> list:
    """Every layer of a stacked parameter subtree: ``n`` nested dicts of
    views, from one ``torch.unbind(0)`` per stacked leaf.  Under autograd
    the leaf's gradient is then one ``stack`` of the layers' gradients
    (``lax.scan``'s transpose), where ``n`` calls of :func:`layer_slice`
    would each add into a zero tensor of the whole stack.  A tree whose
    leaves gather on use (``models.layout.ZeroStack``, serving only)
    gives its layers lazily, one :func:`layer_slice` each."""
    if any(not isinstance(v, torch.Tensor) for _, v in tree_items(tree)):
        return (layer_slice(tree, i) for i in range(n))
    out = [dict() for _ in range(n)]

    def fill(node, dests):
        for k, v in node.items():
            if _is_node(v):
                subs = [d.setdefault(k, {}) for d in dests]
                fill(v, subs)
            else:
                for d, view in zip(dests, torch.unbind(v, 0)):
                    d[k] = view
    fill(tree, out)
    return out
