"""Parameter declaration machinery.  Port of ``repro.models.params``.

Each model family declares its parameters once as a nested dict of
``ParamDef`` (shape + logical axes + init); from that single table come
initialisation and parameter counts.  The parameter tree itself is an
``nn.Module`` of nested ``nn.ParameterDict``s (:class:`ParamTree`): its
``state_dict()`` keys are the JAX tree paths joined by ``.``, and stacked
layer tensors keep their leading ``(n_layers, ...)`` axis.  Parameters are
frozen (``requires_grad=False``): the port's model slice is inference only.

The sharding helpers of the JAX module (``param_specs``,
``param_shardings``, ``param_structs``) are not ported yet (ROADMAP A13c,
the distributed model slice).
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

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
    frozen ``nn.Parameter``s, so ``state_dict()`` keys read
    ``"layers.attn.wq"``."""

    @classmethod
    def from_tensors(cls, tree: Mapping) -> "ParamTree":
        out = cls()
        for k in sorted(tree):
            v = tree[k]
            out[k] = (cls.from_tensors(v) if _is_node(v)
                      else nn.Parameter(v, requires_grad=False))
        return out


def init_params(defs, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device=None) -> ParamTree:
    """Initialise a parameter tree from its declaration (deterministic).

    The same per-leaf distributions and scales as the JAX package: N(0, 1)
    times ``scale`` (default ``1/sqrt(shape[-2])``, ``1/sqrt(shape[-1])``
    for vectors), zeros or ones; leaves are drawn in sorted path order
    from ``generator``, which must live on ``device`` (default: the card,
    see :func:`repro_torch.device.resolve_device`; pass ``device="cpu"``
    with a CPU generator to run on the CPU).  The draws differ from
    ``jax.random``'s; tests that compare the packages convert one tree
    with :func:`from_jax_params`."""
    device = resolve_device(device)
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
    out: dict = {}
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
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return ParamTree.from_tensors(out)


def from_jax_params(tree: Mapping, device=None,
                    dtype: Optional[torch.dtype] = None) -> ParamTree:
    """The JAX package's parameter tree (nested dict of arrays; anything
    ``np.asarray`` takes) as a :class:`ParamTree` on ``device`` (default:
    the card, as :func:`init_params`), in ``dtype`` (default float32, the
    JAX package's parameter type).  The parity tests use it so that both
    packages compute with the same weights."""
    device = resolve_device(device)

    def convert(node):
        if _is_node(node):
            return {k: convert(v) for k, v in node.items()}
        t = torch.from_numpy(np.array(np.asarray(node, np.float32)))
        return t.to(device=device, dtype=dtype or torch.float32)
    return ParamTree.from_tensors(convert(tree))


def layer_slice(tree: Mapping, i: int) -> dict:
    """Layer ``i`` of a stacked parameter subtree (the leading axis), as a
    nested dict of views: the twin of ``jax.tree.map(lambda a: a[i], t)``."""
    return {k: (layer_slice(v, i) if _is_node(v) else v[i])
            for k, v in tree.items()}
