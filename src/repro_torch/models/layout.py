"""How one call of the LM lies over a device mesh: the collectives that
the port's model issues by hand where GSPMD partitions the JAX package's
(``models.common``, ``models.lm``).

A :class:`Layout` is made from ``sharding.MeshRules``, the model's
parameter declarations and the call's global batch.  Each attribute is
the ``core.collectives.Collectives`` over the mesh axes that one
dimension is sharded over, or ``None`` where that dimension is whole on
every rank (no axes, or axes of size 1): so on a ``(1, 1)`` mesh every
attribute is ``None`` and the model runs exactly the code it runs
without a mesh.

* ``batch``: the axes the batch is split over (``("pod", "data")``, a
  prefix of them, or none where the batch does not divide).
* ``heads``, ``kv``, ``wo``: the query heads of ``wq``, the KV heads of
  ``wk``/``wv`` and the rows of ``wo`` (``model``).
* ``ff``, ``moe_ff``: the hidden width of the SwiGLU and of the experts.
* ``vocab``: the vocabulary of ``embed`` and ``lm_head``; ``embed_fsdp``,
  ``head_fsdp``, ``adapter_fsdp``: their ``embed`` width under fsdp
  (``data``), gathered where they are used.
* :meth:`cache`: the decode ring's slots (``kv_seq``/``long_seq``) and
  KV heads.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.collectives import Collectives


def live(comm: Optional[Collectives]) -> Optional[Collectives]:
    """``comm`` if its axes hold more than one shard, else ``None``."""
    return comm if comm is not None and comm.size > 1 else None


class Layout:
    def __init__(self, cfg, rules, batch: int, defs: dict):
        self.rules = rules
        self.cfg = cfg
        self.batch_size = batch
        bspec = rules.spec(("batch",), (batch,))
        self.batch = live(rules.comm(bspec.axes(0)))
        #: True when the batch splits over every data axis (the JAX
        #: package's condition for the ``shard_map`` MoE dispatch)
        self.batch_even = batch % max(rules.data_size, 1) == 0
        self._batch_axes = set(bspec.axes(0))

        def comm(d, dim):
            return live(rules.comm(rules.spec(d.axes, d.shape).axes(dim)))
        lay = defs["layers"]
        att = lay["attn"]
        self.heads = comm(att["wq"], 2)
        self.kv = comm(att["wk"], 2)
        self.wo = comm(att["wo"], 1)
        self.ff = comm(lay["mlp"]["w_gate"], 2) if "mlp" in lay else None
        self.moe_ff = (comm(lay["moe"]["w_gate"], 3) if "moe" in lay
                       else None)
        self.vocab = comm(defs["embed"], 0)
        self.embed_fsdp = comm(defs["embed"], 1)
        self.head_fsdp = (comm(defs["lm_head"], 0) if "lm_head" in defs
                          else None)
        self.head_vocab = (comm(defs["lm_head"], 1) if "lm_head" in defs
                           else self.vocab)
        self.adapter_fsdp = (comm(defs["frontend_adapter"], 1)
                             if "frontend_adapter" in defs else None)
        if self.heads is None and (self.kv is not None):
            raise ValueError(f"{cfg.name}: KV heads sharded over "
                             f"{self.kv.axes} with the query heads whole")
        if self.heads is not None and (
                self.wo is None or self.wo.axes != self.heads.axes):
            raise ValueError(f"{cfg.name}: query heads over "
                             f"{self.heads.axes}, wo rows over "
                             f"{None if self.wo is None else self.wo.axes}")
        if self.kv is not None and self.kv.axes != self.heads.axes:
            raise ValueError(f"{cfg.name}: KV heads over {self.kv.axes}, "
                             f"query heads over {self.heads.axes}")
        self._caches: dict = {}

    def reduce_for(self, comm: Optional[Collectives]
                   ) -> Optional[Collectives]:
        """The axes among ``comm``'s over which cotangents are partial
        sums (those that split the batch): what a parameter gathered over
        ``comm`` sums its gradient over."""
        if comm is None:
            return None
        axes = tuple(a for a in comm.axes if a in self._batch_axes)
        return live(self.rules.comm(axes))

    def rows(self, x):
        """This rank's rows (dim 0) of a global batch (a tensor or numpy
        array)."""
        if self.batch is None:
            return x
        n = x.shape[0] // self.batch.size
        i = self.batch.index()
        return x[i * n:(i + 1) * n]

    def cache(self, cache_defs: dict):
        """(slot collectives, KV-head collectives) of the decode ring
        declared by ``cache_defs`` (``lm.cache_defs``)."""
        leaf = cache_defs["k"]
        key = leaf.shape
        if key not in self._caches:
            spec = self.rules.spec(leaf.axes, leaf.shape)
            cb = live(self.rules.comm(spec.axes(1)))
            if (None if cb is None else cb.axes) != (
                    None if self.batch is None else self.batch.axes):
                raise ValueError(f"the ring's batch over {spec.axes(1)}, "
                                 "the activations' over "
                                 f"{None if self.batch is None else self.batch.axes}")
            self._caches[key] = (live(self.rules.comm(spec.axes(2))),
                                 live(self.rules.comm(spec.axes(3))))
        return self._caches[key]


def layout(cfg, rules, batch: int, defs_fn) -> Optional[Layout]:
    """The (cached) layout of a call over ``batch`` sequences; ``None``
    without rules."""
    if rules is None:
        return None
    key = (cfg, int(batch))
    if key not in rules.layouts:
        rules.layouts[key] = Layout(cfg, rules, int(batch), defs_fn(cfg))
    return rules.layouts[key]


def gather_batch(lay: Optional[Layout], x: torch.Tensor) -> torch.Tensor:
    """The global batch (dim 0) of every rank's rows (no backward)."""
    if lay is None or lay.batch is None:
        return x
    return lay.batch.all_gather(x.detach(), 0)
