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
  The hybrid family's attention+MLP block is its one shared block; the
  enc-dec family's are its decoder's, whose declarations its encoder's
  blocks and the cross attention share (the same axes).
* ``ssm``: the Mamba2 layers' ``ssm_inner`` columns and ``ssm_heads``
  (``model``); ``conv``: the decode cache's conv-window columns.
* The xLSTM family (no attention: ``kv``, ``wo`` and ``moe_ff`` are
  ``None``): ``ff`` the mLSTM blocks' ``ff`` columns and ``heads`` their
  heads (one set of axes for both: a rank's columns are its heads'), or
  ``heads`` ``None`` where the heads do not divide the ``ff`` axes (4
  heads over a 16-way ``model`` axis: every rank then runs every head);
  ``rec`` the sLSTM blocks' heads (``r_gates``, the cache's c, n, m);
  ``mlp_up`` and ``mlp_down`` the sLSTM's gated MLP's columns and rows.
* ``vocab``: the vocabulary of ``embed`` and ``lm_head``; ``embed_fsdp``,
  ``head_fsdp``, ``adapter_fsdp``: their ``embed`` width under fsdp
  (``data``), gathered where they are used.
* :meth:`cache`: the decode ring's slots (``kv_seq``/``long_seq``) and
  KV heads, and the enc-dec family's cross-attention cache's frames
  (``kv_seq``) and KV heads.

Serving under ``fsdp`` may hold every weight ZeRO-extended over the data
axes (``train.optim.zero1_spec`` of its layout: the dry run's serve
cells of large models, ZeRO-inference).  :meth:`Layout.serve_params`
reads that layout from the blocks' shapes and gathers each weight where
it is used: an unstacked one at once, a stacked one a layer (or group)
at a time as ``params.layer_slice`` takes it (:class:`ZeroStack`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.collectives import Collectives
from .params import leaf_at, tree_from_items, tree_items


class ZeroStack:
    """A stacked weight held ZeRO-extended: ``block`` is this rank's
    block, split over ``comm``'s (data) axes along ``dim``, below
    ``stack`` leading stacked dimensions.  ``[i]`` is layer (or group)
    ``i`` in the compute layout, gathered: one all-gather of this rank's
    piece of it, or, where the layers themselves are split, of every
    rank's layer at ``i``'s position, of which the owner's is kept.  A
    gathered weight is contiguous, as the compute layout's block is (the
    products then take the same path, bit for bit)."""

    def __init__(self, block: torch.Tensor, dim: int, comm: Collectives,
                 stack: int):
        self.block, self.dim, self.comm, self.stack = block, dim, comm, stack

    @property
    def shape(self) -> torch.Size:
        """The leaf's shape in the compute layout."""
        s = list(self.block.shape)
        s[self.dim] *= self.comm.size
        return torch.Size(s)

    def __getitem__(self, i: int):
        b = self.block
        if self.dim == 0:
            n = b.shape[0]
            return self.comm.all_gather(b[i % n].unsqueeze(0), 0)[i // n]
        if self.stack > 1:
            return ZeroStack(b[i], self.dim - 1, self.comm, self.stack - 1)
        return self.comm.all_gather(b[i], self.dim - 1).contiguous()


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
            """The collectives over dimension ``dim`` (from the end when
            negative: stacked and unstacked leaves alike)."""
            dim = dim % len(d.shape)
            return live(rules.comm(rules.spec(d.axes, d.shape).axes(dim)))
        self.heads = self.kv = self.wo = self.ff = self.moe_ff = None
        self.ssm = self.conv = None
        self.rec = self.mlp_up = self.mlp_down = None
        layers = defs.get("layers", {})
        if "mlstm_main" in layers:
            self._xlstm_layout(cfg, layers, comm)
        else:
            # the attention+MLP block: stacked per layer, the hybrid
            # family's one shared block, or the enc-dec decoder's
            lay = defs.get("shared", defs.get("decoder", layers))
            att = lay["attn"]
            self.heads = comm(att["wq"], -2)
            self.kv = comm(att["wk"], -2)
            self.wo = comm(att["wo"], -2)
            self.ff = (comm(lay["mlp"]["w_gate"], -1) if "mlp" in lay
                       else None)
            self.moe_ff = (comm(lay["moe"]["w_gate"], -1) if "moe" in lay
                           else None)
            self._check_attention(cfg)
        mamba = layers.get("mamba_main")
        if mamba is not None:
            self._ssm_layout(cfg, rules, mamba, comm)
        self.vocab = comm(defs["embed"], 0)
        self.embed_fsdp = comm(defs["embed"], 1)
        self.head_fsdp = (comm(defs["lm_head"], 0) if "lm_head" in defs
                          else None)
        self.head_vocab = (comm(defs["lm_head"], 1) if "lm_head" in defs
                           else self.vocab)
        self.adapter_fsdp = (comm(defs["frontend_adapter"], 1)
                             if "frontend_adapter" in defs else None)
        self._caches: dict = {}
        self._defs = defs

    def serve_params(self, params):
        """``params`` with every ZeRO-extended weight gathered where it is
        used (see the module's docstring); ``params`` itself when none
        is."""
        from ..train.optim import zero1_spec
        from ..sharding.rules import Sharding
        rules, out, changed = self.rules, [], False
        for path, d in tree_items(self._defs):
            leaf = leaf_at(params, path)
            compute = rules.sharding(d.axes, d.shape)
            if tuple(leaf.shape) == compute.local_shape(d.shape):
                out.append((path, leaf))
                continue
            zspec = zero1_spec(compute.spec, d.shape, rules)
            zero = Sharding(rules.mesh, zspec)
            if tuple(leaf.shape) != zero.local_shape(d.shape):
                raise ValueError(
                    f"{'.'.join(path)}: block {tuple(leaf.shape)} is "
                    f"neither the compute layout's "
                    f"{compute.local_shape(d.shape)} nor the ZeRO one's "
                    f"{zero.local_shape(d.shape)} of {tuple(d.shape)}")
            dim = next(i for i in range(len(d.shape))
                       if zspec.axes(i) != compute.spec.axes(i))
            comm = rules.comm(zspec.axes(dim))
            stack = 0
            while stack < len(d.axes) and d.axes[stack] == "layers":
                stack += 1
            out.append((path, ZeroStack(leaf, dim, comm, stack) if stack
                        else comm.all_gather(leaf, dim).contiguous()))
            changed = True
        return tree_from_items(out) if changed else params

    def _check_attention(self, cfg) -> None:
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

    def _ssm_layout(self, cfg, rules, mamba: dict, comm) -> None:
        """``ssm``: the Mamba2 layers' ``ssm_inner`` columns and
        ``ssm_heads`` (one set of axes for both); ``conv``: the decode
        cache's conv-window columns (``ssm_inner`` over d_inner + 2N)."""
        self.ssm = comm(mamba["wz"], -1)
        want = None if self.ssm is None else self.ssm.axes
        for name, dim in (("wx", -1), ("norm_scale", -1), ("out_proj", -2),
                          ("wdt", -1), ("dt_bias", -1), ("A_log", -1),
                          ("D_skip", -1)):
            other = comm(mamba[name], dim)
            got = None if other is None else other.axes
            if got != want:
                raise ValueError(f"{cfg.name}: Mamba2 {name} over {got}, "
                                 f"wz columns over {want}")
        width = cfg.d_inner + 2 * cfg.ssm_state
        self.conv = live(rules.comm(rules.spec(("ssm_inner",), (width,))
                                    .axes(0)))
        if self.conv is not None and self.ssm is None:
            raise ValueError(f"{cfg.name}: the conv window over "
                             f"{self.conv.axes} with d_inner whole")

    def _xlstm_layout(self, cfg, layers: dict, comm) -> None:
        """The xLSTM blocks' axes: every mLSTM leaf split over ``ff`` must
        lie over ``w_up``'s column axes, and its ``heads`` (``wi``,
        ``wf``) over them too (a rank computes its heads from its columns
        of q, k, v) or, where the heads do not divide, whole (every rank
        gathers q, k, v and runs every head); the sLSTM's gated MLP may
        keep ``w_mlp_down`` whole where its rows do not divide."""
        def axes(c):
            return None if c is None else c.axes

        heads = {}
        for name in ("mlstm_main", "mlstm_tail"):
            if name not in layers:
                continue
            m = layers[name]
            if self.ff is None:
                self.ff = comm(m["w_up"], -1)
            for leaf, dim in (("w_up", -1), ("wq", -1), ("wk", -1),
                              ("wv", -1), ("wi", -1), ("wf", -1),
                              ("norm_scale", -1), ("w_down", -2)):
                got = axes(comm(m[leaf], dim))
                if leaf in ("wi", "wf"):
                    heads[got] = leaf
                    if got is None:
                        continue
                if got != axes(self.ff):
                    raise ValueError(f"{cfg.name}: mLSTM {leaf} over {got}, "
                                     f"w_up columns over {axes(self.ff)}")
        if len(heads) > 1:
            raise ValueError(f"{cfg.name}: mLSTM heads over {sorted(heads)}")
        self.heads = self.ff if axes(self.ff) in heads else None
        s = layers.get("slstm")
        if s is not None:
            self.rec = comm(s["r_gates"], -3)
            self.mlp_up = comm(s["w_mlp_up"], -1)
            self.mlp_down = comm(s["w_mlp_down"], -2)
            if self.mlp_down is not None and axes(self.mlp_down) != axes(
                    self.mlp_up):
                raise ValueError(f"{cfg.name}: sLSTM w_mlp_down rows over "
                                 f"{axes(self.mlp_down)}, w_mlp_up columns "
                                 f"over {axes(self.mlp_up)}")

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

    def cache(self, cache_defs: dict, name: str = "k"):
        """(slot collectives, KV-head collectives) of the decode ring
        declared as ``cache_defs[name]`` (``lm.cache_defs``; the enc-dec
        family's ``cross_k`` too): a (L, B, slots, KV heads, head dim)
        leaf."""
        leaf = cache_defs[name]
        key = (leaf.shape, leaf.axes)
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
