"""Decoder-only LM: the dense, MoE, hybrid-SSM (Zamba2) and xLSTM families.
Port of ``repro.models.lm``.

One parameter-declaration table per family (``param_defs``), one forward
for full sequences (``forward``), the training loss (``loss_fn``), and
serving: ``prefill`` (one full forward that also packs each layer's K/V
into a ring cache) and ``decode_step`` (one token per sequence against
that cache).  Layers run as a Python loop over the stacked parameters
(the JAX package's ``lax.scan``; ``cfg.scan_layers`` changes no number,
so the port reads it and loops either way).  ``prefill`` and
``decode_step`` take each layer's views with ``params.layer_slice``;
``forward`` (and so ``loss_fn``) takes all of them at once with
``params.layer_views`` (one ``unbind`` per stacked leaf, whose backward
is one ``stack``) and, with ``cfg.remat == "block"`` while grad is
enabled, recomputes each block in the backward
(``torch.utils.checkpoint``, the JAX package's ``jax.remat``).

Every RMSNorm passes ``use_pallas=cfg.use_pallas`` (True: the ``rmsnorm``
kernel).  Decode attention follows ``cfg.attn_impl`` (``"pallas"``: the
``decode_attention`` kernel; ``common.attention_decode``).  Prefill
attention is the JAX package's: ``common._sdpa``, or
``common.blocked_sdpa`` when ``attn_impl == "blocked"`` and the prompt is
longer than ``q_block``; it never calls ``flash_attention``.
``decode_step`` writes the cache's K/V tensors in place and reads its
``pos`` on the host once per step.  The kernels have no backward, in
either package, so training (``repro_torch.train.step``) refuses their
switches.

Over a device mesh (``rules``, a ``sharding.MeshRules``) each rank holds
its blocks of the parameters (``params.init_params(rules=...)``) and of
the cache (``init_cache(rules=...)``), takes the global batch and
computes on its rows of it (``models.layout``): the embedding
vocab-parallel where ``vocab`` is sharded (a masked local lookup, then a
``psum``), the blocks tensor-parallel (``models.common``), the logits
vocab-sharded.  ``forward``, ``prefill`` and ``decode_step`` return the
global logits, gathered (no backward through the gather); ``loss_fn``
computes a vocab-parallel cross entropy where the vocabulary is sharded,
and its mean over the global batch's valid labels.  On a ``(1, 1)`` mesh
every collective is the identity and the numbers are those without one,
bit for bit.

The ``hybrid_ssm`` family (Zamba2) is groups of ``attn_every`` Mamba2
layers (``models.ssm``), each group ending with the one *shared*
attention+MLP block, then ``n_layers % attn_every`` tail Mamba2 layers:
``layers.mamba_main`` is stacked (n_groups, period, ...),
``layers.mamba_tail`` (tail, ...), ``shared`` unstacked.  Its cache holds
each Mamba2 layer's SSM state (float32) and conv window (the compute
dtype) and one KV ring per invocation of the shared block.  A prompt
longer than ``ssm_chunk`` must be a whole number of chunks, as in the JAX
package.  ``prefill`` refuses a pattern without a group (``n_layers <
attn_every``), which has no ring to fill (the JAX function fails there).
A prompt shorter than ``conv_width - 1`` tokens prefills (its logits are
right) but leaves the conv windows short, and ``decode_step`` refuses
such a cache with a ``ValueError``, where the JAX package's decode step
fails in its depthwise conv; the windows are not padded, which would
answer where the JAX package cannot.  The short length travels with the
cache as one more entry, a host scalar (:data:`SHORT_PREFILL`), so the
leaves keep their shapes and a copy of the cache refuses too.

The ``xlstm`` family is groups of ``slstm_every`` blocks, ``period - 1``
mLSTM blocks then one sLSTM block (``models.xlstm``), then ``n_layers %
slstm_every`` tail mLSTM blocks: ``layers.mlstm_main`` is stacked
(n_groups, period - 1, ...), ``layers.slstm`` (n_groups, ...),
``layers.mlstm_tail`` (tail, ...); with ``slstm_every == 0`` every block
is an mLSTM, ``mlstm_main`` stacked (n_layers, 1, ...).  Its cache has no
ring: ``pos`` and each block's recurrent state, nested as the JAX
package's (``mlstm_main``/``mlstm_tail``: ``c``, ``n``, ``m``;
``slstm``: ``c``, ``n``, ``h``, ``m``), written in place by
``decode_step``, which reads nothing on the host.  A group-less pattern
(``n_layers < slstm_every``) serves, as in the JAX package.

The ``encdec`` family (seamless-m4t) is ``models.encdec``'s, whose
encoder and cross-attention cache this module does not know; it shares
``cache_len``, ``_ring_pack``, ``compute_dtype``, ``embed_tokens``, the
cache leaves (``CacheLeaf``, ``fill_cache``) and the vocab-parallel loss
from here.  This module's entries refuse it (``models.api.get_model``
dispatches there).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.collectives import copy_to, gather_from, reduce_from
from ..device import resolve_device
from . import common, ssm, xlstm
from .layout import gather_batch, layout
from .params import ParamDef, Struct, layer_slice, layer_views

#: The families the port declares: ``encdec`` in ``models.encdec``, the
#: decoder-only ones here.
FAMILIES = ("dense", "moe", "hybrid_ssm", "xlstm", "encdec")
#: The entry of a hybrid cache whose prefill was shorter than
#: ``conv_width - 1`` tokens: the prompt's length, a CPU int64 scalar.
#: Only such caches have it, and ``decode_step`` refuses them.
SHORT_PREFILL = "short_prefill"


# ---------------------------------------------------------------------------
# Parameter declaration
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sa = ("layers",) * len(stack)
    out = {
        "wq": ParamDef(stack + (d, h, hd), sa + (None, "heads", None)),
        "wk": ParamDef(stack + (d, kv, hd), sa + (None, "kv_heads", None)),
        "wv": ParamDef(stack + (d, kv, hd), sa + (None, "kv_heads", None)),
        "wo": ParamDef(stack + (h * hd, d), sa + ("heads", None)),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamDef(stack + (hd,), sa + (None,), "ones")
        out["k_norm"] = ParamDef(stack + (hd,), sa + (None,), "ones")
    return out


def _mlp_defs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    sa = ("layers",) * len(stack)
    return {
        "w_gate": ParamDef(stack + (d, f), sa + (None, "ff")),
        "w_up": ParamDef(stack + (d, f), sa + (None, "ff")),
        "w_down": ParamDef(stack + (f, d), sa + ("ff", None)),
    }


def _moe_defs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    sa = ("layers",) * len(stack)
    return {
        "router": ParamDef(stack + (d, e), sa + (None, "experts")),
        "w_gate": ParamDef(stack + (e, d, f), sa + ("experts", None, "moe_ff")),
        "w_up": ParamDef(stack + (e, d, f), sa + ("experts", None, "moe_ff")),
        "w_down": ParamDef(stack + (e, f, d), sa + ("experts", "moe_ff", None)),
    }


def _mamba_defs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, w = cfg.ssm_heads, cfg.conv_width
    sa = ("layers",) * len(stack)
    return {
        "norm": ParamDef(stack + (d,), sa + (None,), "ones"),
        "wz": ParamDef(stack + (d, di), sa + (None, "ssm_inner")),
        "wx": ParamDef(stack + (d, di), sa + (None, "ssm_inner")),
        "wB": ParamDef(stack + (d, n), sa + (None, None)),
        "wC": ParamDef(stack + (d, n), sa + (None, None)),
        "wdt": ParamDef(stack + (d, h), sa + (None, "ssm_heads")),
        "conv_w": ParamDef(stack + (w, di + 2 * n), sa + (None, None),
                           "normal", 0.5),
        "conv_b": ParamDef(stack + (di + 2 * n,), sa + (None,), "zeros"),
        "dt_bias": ParamDef(stack + (h,), sa + ("ssm_heads",), "zeros"),
        "A_log": ParamDef(stack + (h,), sa + ("ssm_heads",), "zeros"),
        "D_skip": ParamDef(stack + (h,), sa + ("ssm_heads",), "ones"),
        "norm_scale": ParamDef(stack + (di,), sa + ("ssm_inner",), "ones"),
        "out_proj": ParamDef(stack + (di, d), sa + ("ssm_inner", None)),
    }


def _mlstm_defs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d = cfg.d_model
    dm = int(d * cfg.mlstm_proj)
    h = cfg.n_heads
    sa = ("layers",) * len(stack)
    return {
        "norm": ParamDef(stack + (d,), sa + (None,), "ones"),
        "w_up": ParamDef(stack + (d, 2 * dm), sa + (None, "ff")),
        "wq": ParamDef(stack + (dm, dm), sa + (None, "ff")),
        "wk": ParamDef(stack + (dm, dm), sa + (None, "ff")),
        "wv": ParamDef(stack + (dm, dm), sa + (None, "ff")),
        "wi": ParamDef(stack + (dm, h), sa + (None, "heads")),
        "wf": ParamDef(stack + (dm, h), sa + (None, "heads")),
        "norm_scale": ParamDef(stack + (dm,), sa + ("ff",), "ones"),
        "w_down": ParamDef(stack + (dm, d), sa + ("ff", None)),
    }


def _slstm_defs(cfg: ModelConfig, stack: tuple = ()) -> dict:
    d = cfg.d_model
    h, hp = cfg.n_heads, cfg.d_model // cfg.n_heads
    ds = int(2 * d * cfg.slstm_proj)      # gated MLP: up to 2×(proj·d)
    sa = ("layers",) * len(stack)
    return {
        "norm": ParamDef(stack + (d,), sa + (None,), "ones"),
        "w_gates": ParamDef(stack + (d, 4, d), sa + (None, None, None)),
        "r_gates": ParamDef(stack + (4, h, hp, hp),
                            sa + (None, "heads", None, None), "normal", 0.1),
        "b_i": ParamDef(stack + (d,), sa + (None,), "zeros"),
        "b_f": ParamDef(stack + (d,), sa + (None,), "ones"),
        "norm_scale": ParamDef(stack + (d,), sa + (None,), "ones"),
        "w_mlp_up": ParamDef(stack + (d, ds), sa + (None, "ff")),
        "w_mlp_down": ParamDef(stack + (ds // 2, d), sa + ("ff", None)),
    }


def _pattern(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, period, tail) of the block pattern."""
    period = cfg.layer_pattern_period
    return cfg.n_layers // period, period, cfg.n_layers % period


def _check_family(cfg: ModelConfig, what: str,
                  decoder_only: bool = True) -> None:
    """Raise for a family the port does not declare, and (``decoder_only``)
    for the enc-dec family, whose entries are ``models.encdec``'s."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{what}: unknown family {cfg.family!r}")
    if decoder_only and cfg.family == "encdec":
        raise ValueError(f"{what} of the 'encdec' family is "
                         "models.encdec's (models.api.get_model)")


def param_defs(cfg: ModelConfig) -> dict:
    _check_family(cfg, "the parameter table")
    d, v = cfg.d_model, cfg.vocab_size
    out: dict = {
        "embed": ParamDef((v, d), ("vocab", "embed"), "normal", 1.0),
        "out_norm": ParamDef((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef((d, v), ("embed", "vocab"))
    if cfg.frontend == "patch":
        out["frontend_adapter"] = ParamDef((cfg.frontend_dim, d),
                                           (None, "embed"))
    if cfg.family == "hybrid_ssm":
        ng, period, tail = _pattern(cfg)
        out["layers"] = {"mamba_main": _mamba_defs(cfg, (ng, period))}
        if tail:
            out["layers"]["mamba_tail"] = _mamba_defs(cfg, (tail,))
        out["shared"] = {
            "attn_norm": ParamDef((d,), (None,), "ones"),
            "attn": _attn_defs(cfg),
            "mlp_norm": ParamDef((d,), (None,), "ones"),
            "mlp": _mlp_defs(cfg),
        }
        return out
    if cfg.family == "xlstm":
        ng, period, tail = _pattern(cfg)
        if cfg.slstm_every:
            out["layers"] = {"mlstm_main": _mlstm_defs(cfg, (ng, period - 1)),
                             "slstm": _slstm_defs(cfg, (ng,))}
            if tail:
                out["layers"]["mlstm_tail"] = _mlstm_defs(cfg, (tail,))
        else:
            out["layers"] = {"mlstm_main": _mlstm_defs(cfg,
                                                       (cfg.n_layers, 1))}
        return out
    stack = (cfg.n_layers,)
    out["layers"] = {
        "attn_norm": ParamDef(stack + (d,), ("layers", None), "ones"),
        "attn": _attn_defs(cfg, stack),
        "mlp_norm": ParamDef(stack + (d,), ("layers", None), "ones"),
    }
    if cfg.family == "moe":
        out["layers"]["moe"] = _moe_defs(cfg, stack)
    else:
        out["layers"]["mlp"] = _mlp_defs(cfg, stack)
    return out


# ---------------------------------------------------------------------------
# Blocks (forward)
# ---------------------------------------------------------------------------

def _dense_block(cfg, p, x, positions, aux, lay=None):
    h = common.rmsnorm(x, p["attn_norm"], cfg.norm_eps, cfg.use_pallas)
    x = x + common.attention(cfg, p["attn"], h, positions,
                             impl=cfg.attn_impl, q_block=cfg.q_block,
                             lay=lay)
    h = common.rmsnorm(x, p["mlp_norm"], cfg.norm_eps, cfg.use_pallas)
    if cfg.is_moe:
        y, a = common.moe_ffn(cfg, p["moe"], h, lay)
        aux = aux + a
    else:
        y = common.swiglu(p["mlp"], h, lay)
    return x + y, aux


def _mamba_block(cfg, p, x, lay=None):
    h = common.rmsnorm(x, p["norm"], cfg.norm_eps, cfg.use_pallas)
    return x + ssm.ssd_forward(cfg, p, h, lay=lay)


def _shared_attn_block(cfg, p, x, positions, lay=None):
    h = common.rmsnorm(x, p["attn_norm"], cfg.norm_eps, cfg.use_pallas)
    x = x + common.attention(cfg, p["attn"], h, positions,
                             impl=cfg.attn_impl, q_block=cfg.q_block,
                             lay=lay)
    h = common.rmsnorm(x, p["mlp_norm"], cfg.norm_eps, cfg.use_pallas)
    return x + common.swiglu(p["mlp"], h, lay)


def _hybrid_group(cfg, sl, shared, x, positions, lay=None):
    """One group: ``period`` Mamba2 layers (the views of ``sl``), then the
    shared attention+MLP block."""
    for p in layer_views(sl, cfg.layer_pattern_period):
        x = _mamba_block(cfg, p, x, lay)
    return _shared_attn_block(cfg, shared, x, positions, lay)


def _mlstm_block(cfg, p, x, lay=None):
    h = common.rmsnorm(x, p["norm"], cfg.norm_eps, cfg.use_pallas)
    return x + xlstm.mlstm_forward(cfg, p, h, lay=lay)


def _slstm_block(cfg, p, x, lay=None):
    h = common.rmsnorm(x, p["norm"], cfg.norm_eps, cfg.use_pallas)
    return x + xlstm.slstm_forward(cfg, p, h, lay=lay)


def _xlstm_group(cfg, msl, ssl, x, lay=None):
    """One group: its mLSTM blocks (the views of ``msl``), then the sLSTM
    block ``ssl`` (``None`` where ``slstm_every`` is 0)."""
    for p in layer_views(msl, msl["w_up"].shape[0]):
        x = _mlstm_block(cfg, p, x, lay)
    return x if ssl is None else _slstm_block(cfg, ssl, x, lay)


def _xlstm_stacks(lp) -> tuple:
    """(n_groups, mLSTM blocks a group, tail mLSTM blocks) of an xLSTM
    parameter tree's stacks."""
    ng, nm = lp["mlstm_main"]["w_up"].shape[:2]
    nt = lp["mlstm_tail"]["w_up"].shape[0] if "mlstm_tail" in lp else 0
    return ng, nm, nt


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The JAX package's compute type: bfloat16 for ``dtype="bfloat16"``,
    else float32.  ``dtype="float64"`` (the port only) computes every
    float32 step in float64 (``common.wide``): the evaluation that grounds
    the float32 tolerances."""
    return {"bfloat16": torch.bfloat16,
            "float64": torch.float64}.get(cfg.dtype, torch.float32)


def _lookup(emb: torch.Tensor, tokens: torch.Tensor, lay) -> torch.Tensor:
    """Rows ``tokens`` of the embedding table: over a mesh whose vocab is
    sharded, the rows of this rank's block (zeros for the others), then a
    ``psum`` (exactly one rank holds each row)."""
    c = None if lay is None else lay.vocab
    if c is None:
        return emb[tokens]
    n = emb.shape[0]
    local = tokens - c.index() * n
    hit = (local >= 0) & (local < n)
    rows = emb[torch.clamp(local, 0, n - 1)]
    rows = torch.where(hit[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_from(c, rows)


def embed_tokens(cfg: ModelConfig, params, tokens, patches=None,
                 compute_dtype=torch.bfloat16, lay=None):
    """tokens (B,St) [+ patches (B,Fl,frontend_dim)] -> x (B,S,D)."""
    emb = params["embed"].to(compute_dtype)
    if lay is not None:
        emb = gather_from(lay.embed_fsdp, emb, 1,
                          lay.reduce_for(lay.embed_fsdp))
    x = _lookup(emb, tokens, lay)
    if cfg.frontend == "patch":
        if patches is None:
            raise ValueError(f"{cfg.name} takes patch embeddings")
        adapter = params["frontend_adapter"].to(compute_dtype)
        if lay is not None:
            adapter = gather_from(lay.adapter_fsdp, adapter, 1,
                                  lay.reduce_for(lay.adapter_fsdp))
        pe = torch.einsum("bpf,fd->bpd", patches.to(compute_dtype), adapter)
        x = torch.cat([pe, x], dim=1)
    return x


def lm_logits(cfg: ModelConfig, params, x, lay=None):
    """Logits (B,S,V) of the hidden states; over a mesh whose vocab is
    sharded, this rank's block of the vocabulary (B,S,V/shards)."""
    x = common.rmsnorm(x, params["out_norm"], cfg.norm_eps, cfg.use_pallas)
    w = (params["embed"] if cfg.tie_embeddings
         else params["lm_head"]).to(x.dtype)
    vocab = None
    if lay is not None:
        fsdp, dim = ((lay.embed_fsdp, 1) if cfg.tie_embeddings
                     else (lay.head_fsdp, 0))
        w = gather_from(fsdp, w, dim, lay.reduce_for(fsdp))
        vocab = lay.vocab if cfg.tie_embeddings else lay.head_vocab
        x = copy_to(vocab, x)
    if cfg.logits_fp32:      # preferred_element_type=float32
        f32 = common.wide(x.dtype)
        x, w = x.to(f32), w.to(f32)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, w)
    return torch.einsum("bsd,dv->bsv", x, w)


def _logits_vocab(cfg: ModelConfig, lay):
    """The collectives over the logits' vocabulary (``None``: whole)."""
    if lay is None:
        return None
    return lay.vocab if cfg.tie_embeddings else lay.head_vocab


def global_logits(cfg: ModelConfig, logits: torch.Tensor, lay):
    """Every rank's block of the logits (rows, vocabulary) as the global
    logits (no backward)."""
    c = _logits_vocab(cfg, lay)
    if c is not None:
        logits = c.all_gather(logits.detach(), -1)
    return gather_batch(lay, logits)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _as_index(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int64)
    return torch.as_tensor(tokens, dtype=torch.int64, device=device)


def _layout(cfg: ModelConfig, rules, batch: int):
    return layout(cfg, rules, batch, param_defs)


def _forward(cfg: ModelConfig, params, tokens, patches=None,
             positions=None, rules=None):
    """The forward on this rank's rows -> (logits block, aux, layout)."""
    _check_family(cfg, "forward")
    dev = params["embed"].device
    lay = _layout(cfg, rules, len(tokens))
    if lay is not None:
        tokens = lay.rows(tokens)
        patches = None if patches is None else lay.rows(patches)
    if patches is not None:
        patches = torch.as_tensor(patches, device=dev)
    x = embed_tokens(cfg, params, _as_index(tokens, dev), patches,
                     compute_dtype(cfg), lay)
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    if cfg.family == "hybrid_ssm":
        x = _hybrid_forward(cfg, params, x, positions, lay, remat)
        return lm_logits(cfg, params, x, lay), aux, lay
    if cfg.family == "xlstm":
        x = _xlstm_forward(cfg, params, x, lay, remat)
        return lm_logits(cfg, params, x, lay), aux, lay
    for p in layer_views(params["layers"], cfg.n_layers):
        if remat:
            x, aux = checkpoint(_dense_block, cfg, p, x, positions, aux,
                                lay, use_reentrant=False)
        else:
            x, aux = _dense_block(cfg, p, x, positions, aux, lay)
    return lm_logits(cfg, params, x, lay), aux, lay


def _hybrid_forward(cfg, params, x, positions, lay, remat: bool):
    """The hybrid family's blocks: each group (remat as one block, as the
    JAX package's ``jax.remat`` of the scanned group), then each tail
    layer."""
    ssm.check_length(cfg, x.shape[1])
    ng, _, tail = _pattern(cfg)
    lp, shared = params["layers"], params["shared"]
    for sl in layer_views(lp["mamba_main"], ng):
        if remat:
            x = checkpoint(_hybrid_group, cfg, sl, shared, x, positions, lay,
                           use_reentrant=False)
        else:
            x = _hybrid_group(cfg, sl, shared, x, positions, lay)
    if tail:
        for p in layer_views(lp["mamba_tail"], tail):
            if remat:
                x = checkpoint(_mamba_block, cfg, p, x, lay,
                               use_reentrant=False)
            else:
                x = _mamba_block(cfg, p, x, lay)
    return x


def _xlstm_forward(cfg, params, x, lay, remat: bool):
    """The xLSTM family's blocks: each group (remat as one block, as the
    JAX package's ``jax.remat`` of the scanned group), then each tail
    mLSTM block."""
    lp = params["layers"]
    ng, _, nt = _xlstm_stacks(lp)
    slstm = (layer_views(lp["slstm"], ng) if "slstm" in lp
             else [None] * ng)
    for msl, ssl in zip(layer_views(lp["mlstm_main"], ng), slstm):
        if remat:
            x = checkpoint(_xlstm_group, cfg, msl, ssl, x, lay,
                           use_reentrant=False)
        else:
            x = _xlstm_group(cfg, msl, ssl, x, lay)
    if nt:
        for p in layer_views(lp["mlstm_tail"], nt):
            if remat:
                x = checkpoint(_mlstm_block, cfg, p, x, lay,
                               use_reentrant=False)
            else:
                x = _mlstm_block(cfg, p, x, lay)
    return x


def forward(cfg: ModelConfig, params, tokens, patches=None,
            positions=None, rules=None):
    """Full-sequence forward -> (logits (B,S,V), aux_loss scalar).
    ``tokens`` (and ``patches``) may be numpy arrays; they move to the
    parameters' device.  Autograd records only what a trainable tree
    (``requires_grad=True``) feeds; with ``cfg.remat == "block"`` while
    grad is enabled, each block is recomputed in the backward.  Over a
    mesh: the global batch in, the global logits out (gathered, with no
    backward; ``loss_fn`` differentiates through the blocks)."""
    logits, aux, lay = _forward(cfg, params, tokens, patches, positions,
                                rules)
    if lay is not None:
        logits = global_logits(cfg, logits, lay)
    return logits, aux


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                        comm) -> torch.Tensor:
    """-log softmax(logits)[label] with the vocabulary in blocks over
    ``comm``: the ``pmax`` of the maxima, the ``psum`` of the exp-sums
    and of the target logit (on the rank that holds it)."""
    lf = logits.to(torch.float32)
    top = comm.pmax(lf.detach().amax(-1, keepdim=True))
    sums = reduce_from(comm, torch.exp(lf - top).sum(-1, keepdim=True))
    n = lf.shape[-1]
    local = labels - comm.index() * n
    hit = (local >= 0) & (local < n)
    tgt = torch.gather(lf, -1, torch.clamp(local, 0, n - 1)[..., None])
    tgt = reduce_from(comm, torch.where(hit[..., None], tgt,
                                        torch.zeros_like(tgt)))
    return (top + torch.log(sums) - tgt)[..., 0]


def loss_fn(cfg: ModelConfig, params, batch, rules=None):
    """Next-token cross entropy; label -100 is ignored.  -> (loss,
    {"nll", "aux"}): the mean over the valid labels (at least one) of the
    fp32 log-softmax's negative log-likelihood, plus
    ``cfg.router_aux_weight`` times the MoE load-balancing loss.  The
    patch frontend's ``frontend_len`` positions carry no labels.  Over a
    mesh: the sum and the count of the global batch (``psum`` over the
    batch's axes), a vocab-parallel cross entropy where the vocabulary is
    sharded."""
    logits, aux, lay = _forward(cfg, params, batch["tokens"],
                                batch.get("patches"), rules=rules)
    labels = batch["labels"]
    if lay is not None:
        labels = lay.rows(labels)
    labels = _as_index(labels, logits.device)
    if cfg.frontend == "patch":
        pad = torch.full((labels.shape[0], cfg.frontend_len), -100,
                         dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    valid = labels >= 0
    safe = torch.clamp(labels, min=0)
    vocab = _logits_vocab(cfg, lay)
    if vocab is None:
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(lp, -1, safe[..., None])[..., 0]
    else:
        nll = _vocab_parallel_nll(logits, safe, vocab)
    rows = None if lay is None else lay.batch
    total = reduce_from(rows, torch.sum(nll * valid))
    count = valid.sum() if rows is None else rows.psum(valid.sum())
    loss = total / torch.clamp(count, min=1)
    return loss + cfg.router_aux_weight * aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

class CacheLeaf(NamedTuple):
    """Cache-leaf declaration: shape, dtype, fill, and the JAX package's
    logical axes (the layout over a mesh)."""
    shape: tuple
    dtype: torch.dtype
    fill: Any
    axes: tuple


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window else max_len


def cache_defs(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Declaration tree of the decode cache.  ``pos`` = tokens consumed;
    ``k``/``v`` (L, B, Sc, KV, hd) rings, L the layers (dense, MoE) or the
    shared block's invocations (hybrid); ``slot_pos`` (Sc,) the position
    each slot holds (-1 = empty).  The hybrid family adds each Mamba2
    layer's ``ssm_*`` state (..., B, H, hp, N) in float32 and ``conv_*``
    window (..., B, W-1, d_inner + 2N) in ``dtype``, for ``main``
    (n_groups, period, ...) and ``tail`` (tail, ...).  The xLSTM family
    has no ring (:func:`_xlstm_cache_defs`)."""
    _check_family(cfg, "the decode cache")
    c = {"pos": CacheLeaf((), torch.int32, 0, ())}
    if cfg.family == "xlstm":
        c.update(_xlstm_cache_defs(cfg, batch, dtype))
        return c
    sc = cache_len(cfg, max_len)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    seq_ax = "long_seq" if batch == 1 else "kv_seq"
    lead = (cfg.n_layers,)
    if cfg.family == "hybrid_ssm":
        ng, period, tail = _pattern(cfg)
        h, hp, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        di, w = cfg.d_inner, cfg.conv_width
        stacks = {"main": (ng, period)}
        if tail:
            stacks["tail"] = (tail,)
        for name, st in stacks.items():
            la = (None,) * len(st)
            c[f"ssm_{name}"] = CacheLeaf(
                st + (batch, h, hp, n), common.wide(dtype), 0,
                la + ("batch", "ssm_heads", None, None))
            c[f"conv_{name}"] = CacheLeaf(
                st + (batch, w - 1, di + 2 * n), dtype, 0,
                la + ("batch", None, "ssm_inner"))
        lead = (ng,)
    ring = CacheLeaf(lead + (batch, sc, kv, hd), dtype, 0,
                     (None, "batch", seq_ax, "kv_heads", None))
    c.update(k=ring, v=ring,
             slot_pos=CacheLeaf((sc,), torch.int32, -1, (None,)))
    return c


def _xlstm_cache_defs(cfg: ModelConfig, batch: int,
                      dtype: torch.dtype) -> dict:
    """The xLSTM family's states, nested as the JAX package's: each
    mLSTM block's ``c`` (..., B, H, P, P), ``n`` (..., B, H, P) and ``m``
    (..., B, H) in float32 (``m`` filled with -1e30), P the mLSTM head
    width ``d_model · mlstm_proj / n_heads``, for ``mlstm_main``
    (n_groups, period - 1, ...) and ``mlstm_tail`` (tail, ...); each
    sLSTM block's ``c``, ``n`` (n_groups, B, H, d_model / H), ``h``
    (n_groups, B, D) in ``dtype`` and ``m`` (n_groups, B, H)."""
    ng, period, tail = _pattern(cfg)
    h = cfg.n_heads
    hp = int(cfg.d_model * cfg.mlstm_proj) // h
    hps = cfg.d_model // h
    f32 = common.wide(dtype)

    def mstate(lead):
        la = (None,) * len(lead)
        return {
            "c": CacheLeaf(lead + (batch, h, hp, hp), f32, 0,
                           la + ("batch", "heads", None, None)),
            "n": CacheLeaf(lead + (batch, h, hp), f32, 0,
                           la + ("batch", "heads", None)),
            "m": CacheLeaf(lead + (batch, h), f32, -1e30,
                           la + ("batch", "heads")),
        }

    if not cfg.slstm_every:
        return {"mlstm_main": mstate((cfg.n_layers, 1))}
    c = {"mlstm_main": mstate((ng, period - 1)),
         "slstm": {
             "c": CacheLeaf((ng, batch, h, hps), f32, 0,
                            (None, "batch", "heads", None)),
             "n": CacheLeaf((ng, batch, h, hps), f32, 0,
                            (None, "batch", "heads", None)),
             "h": CacheLeaf((ng, batch, cfg.d_model), dtype, 0,
                            (None, "batch", None)),
             "m": CacheLeaf((ng, batch, h), f32, -1e30,
                            (None, "batch", "heads")),
         }}
    if tail:
        c["mlstm_tail"] = mstate((tail,))
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, rules=None,
               device=None) -> dict:
    """The cache of :func:`cache_defs`, filled, on ``device`` (default:
    the card; raises without one), nested as the declarations are.  Over
    a mesh (``rules``): this rank's block of each leaf."""
    return fill_cache(cache_defs(cfg, batch, max_len, dtype), rules,
                      device)


def fill_cache(defs: dict, rules=None, device=None) -> dict:
    """The filled tensors of a tree of ``CacheLeaf`` declarations on
    ``device`` (default: the card); over a mesh (``rules``) this rank's
    block of each."""
    dev = resolve_device(device)

    def make(node):
        if not isinstance(node, CacheLeaf):
            return {k: make(v) for k, v in node.items()}
        shape = node.shape
        if rules is not None:
            shape = rules.sharding(node.axes, shape).local_shape(shape)
        return torch.full(shape, node.fill, dtype=node.dtype, device=dev)
    return make(defs)


def cache_structs(cfg: ModelConfig, batch: int, max_len: int, rules,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """The dry run's stand-ins of the cache (``params.Struct``, laid out
    by ``rules``): see :func:`structs_of_cache`."""
    return structs_of_cache(cache_defs(cfg, batch, max_len, dtype), rules,
                            max_len)


def structs_of_cache(defs: dict, rules, max_len: int) -> dict:
    """``params.Struct`` stand-ins of a tree of ``CacheLeaf``
    declarations.  ``pos`` is a real CPU scalar holding ``max_len - 1``
    (a cache one token short of full), which the decode step reads on
    the host as it reads a cache's."""
    def make(name, node):
        if not isinstance(node, CacheLeaf):
            return {k: make(k, v) for k, v in node.items()}
        sh = None if rules is None else rules.sharding(node.axes,
                                                       node.shape)
        return Struct(tuple(node.shape), node.dtype, sh,
                      max_len - 1 if name == "pos" else None)
    return make(None, defs)


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _attn_block_decode(cfg, p, x, kc, vc, slot_pos, pos: int, lay=None,
                       ring=None):
    h = common.rmsnorm(x, p["attn_norm"], cfg.norm_eps, cfg.use_pallas)
    y, kc, vc, slot_pos = common.attention_decode(
        cfg, p["attn"], h, kc, vc, slot_pos, pos, lay, ring)
    x = x + y
    h = common.rmsnorm(x, p["mlp_norm"], cfg.norm_eps, cfg.use_pallas)
    if cfg.is_moe:
        y, _ = common.moe_ffn(cfg, p["moe"], h, lay)
    else:
        y = common.swiglu(p["mlp"], h, lay)
    return x + y, kc, vc, slot_pos


def _ring(cfg: ModelConfig, lay, batch: int, sc: int):
    """(slot collectives, KV-head collectives) of a ring of ``sc`` slots
    over ``lay`` (``None`` without a mesh)."""
    if lay is None:
        return None
    return lay.cache(cache_defs(cfg, batch, sc))


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, rules=None):
    """One decode step for all sequences. tokens (B,) ints (a tensor or
    anything ``torch.as_tensor`` takes).  Returns (cache, logits (B, V)):
    the K/V rings, ``slot_pos``, the hybrid family's SSM states and conv
    windows and the xLSTM family's states are written in place, ``pos``
    is a new tensor one larger.  Over a mesh: the global tokens in, this
    rank's block of the cache, the global logits out."""
    _check_family(cfg, "decode_step")
    dev = params["embed"].device
    lay = _layout(cfg, rules, len(tokens))
    if lay is not None:
        tokens = lay.rows(tokens)
        params = lay.serve_params(params)
    tokens = _as_index(tokens, dev)
    emb = params["embed"]
    if lay is not None:
        emb = gather_from(lay.embed_fsdp, emb, 1)
    x = _lookup(emb, tokens, lay).to(compute_dtype(cfg))[:, None]  # (B,1,D)
    if cfg.family == "xlstm":
        x = _xlstm_decode(cfg, params, cache, x, lay)
    else:
        x = _ring_decode(cfg, params, cache, x, lay)
    logits = lm_logits(cfg, params, x, lay)[:, 0]
    if lay is not None:
        logits = global_logits(cfg, logits, lay)
    return dict(cache, pos=cache["pos"] + 1), logits


def _ring_decode(cfg, params, cache, x, lay):
    """The decode step of the families with a KV ring (dense, MoE,
    hybrid) over their layers."""
    pos = int(cache["pos"])                  # the step's one host read
    slot_pos = cache["slot_pos"]
    ring = _ring(cfg, lay, lay.batch_size if lay else 0, slot_pos.shape[0])
    if cfg.family == "hybrid_ssm":
        return _hybrid_decode(cfg, params, cache, x, pos, lay, ring)
    lp = params["layers"]
    for i in range(cfg.n_layers):
        x, _, _, slot_pos = _attn_block_decode(
            cfg, layer_slice(lp, i), x, cache["k"][i], cache["v"][i],
            slot_pos, pos, lay, ring)
    return x


def _mamba_decode(cfg, p, x, cache, name: str, idx: tuple, lay):
    """One Mamba2 layer's decode step; its states in ``cache[ssm_<name>]``
    and ``cache[conv_<name>]`` at ``idx`` are written in place."""
    h = common.rmsnorm(x, p["norm"], cfg.norm_eps, cfg.use_pallas)
    sst, cst = cache[f"ssm_{name}"][idx], cache[f"conv_{name}"][idx]
    y, s_new, c_new = ssm.ssd_decode(cfg, p, h, sst, cst, lay)
    sst.copy_(s_new)
    cst.copy_(c_new)
    return x + y


def _hybrid_decode(cfg, params, cache, x, pos: int, lay, ring):
    """The hybrid family's decode step over its groups and tail."""
    short = cache.get(SHORT_PREFILL)
    if short is not None:
        raise ValueError(
            f"{cfg.name}: the prefill took {int(short)} tokens, fewer than "
            f"conv_width - 1 = {cfg.conv_width - 1}: its Mamba2 conv "
            "windows are short, so no decode step follows it (the JAX "
            "package's fails in its depthwise conv)")
    ng, period, tail = _pattern(cfg)
    lp, shared = params["layers"], params["shared"]
    slot_pos = cache["slot_pos"]
    for g in range(ng):
        sl = layer_slice(lp["mamba_main"], g)
        for i in range(period):
            x = _mamba_decode(cfg, layer_slice(sl, i), x, cache, "main",
                              (g, i), lay)
        x, _, _, slot_pos = _attn_block_decode(
            cfg, shared, x, cache["k"][g], cache["v"][g], slot_pos, pos,
            lay, ring)
    for i in range(tail):
        x = _mamba_decode(cfg, layer_slice(lp["mamba_tail"], i), x, cache,
                          "tail", (i,), lay)
    return x


def _store(states: dict, idx, new: dict) -> None:
    """Write a block's new state leaves into the cache's stacks at
    ``idx``, in place."""
    for k, v in new.items():
        states[k][idx] = v


def _mlstm_step(cfg, p, x, states: dict, idx, lay):
    """One mLSTM block's decode step; its state in ``states`` (a cache
    node: ``c``, ``n``, ``m``) at ``idx`` is written in place."""
    h = common.rmsnorm(x, p["norm"], cfg.norm_eps, cfg.use_pallas)
    y, c, n, m = xlstm.mlstm_decode(cfg, p, h, states["c"][idx],
                                    states["n"][idx], states["m"][idx], lay)
    _store(states, idx, {"c": c, "n": n, "m": m})
    return x + y


def _xlstm_decode(cfg, params, cache, x, lay):
    """The xLSTM family's decode step over its groups and tail."""
    lp = params["layers"]
    ng, nm, nt = _xlstm_stacks(lp)
    for g in range(ng):
        sl = layer_slice(lp["mlstm_main"], g)
        for i in range(nm):
            x = _mlstm_step(cfg, layer_slice(sl, i), x, cache["mlstm_main"],
                            (g, i), lay)
        if "slstm" in lp:
            p, st = layer_slice(lp["slstm"], g), cache["slstm"]
            h = common.rmsnorm(x, p["norm"], cfg.norm_eps, cfg.use_pallas)
            y, (c, n, hs, m) = xlstm.slstm_decode(
                cfg, p, h, (st["c"][g], st["n"][g], st["h"][g], st["m"][g]),
                lay)
            _store(st, g, {"c": c, "n": n, "h": hs, "m": m})
            x = x + y
    for i in range(nt):
        x = _mlstm_step(cfg, layer_slice(lp["mlstm_tail"], i), x,
                        cache["mlstm_tail"], (i,), lay)
    return x


# ---------------------------------------------------------------------------
# Batched prefill (build the cache from one full forward pass)
# ---------------------------------------------------------------------------

def _ring_pack(full: torch.Tensor, sc: int, s: int):
    """Pack per-position k/v (B,S,...) into a ring cache (B,sc,...):
    slot i holds the largest pos < s with pos ≡ i (mod sc); -1 = empty."""
    slots = torch.arange(sc, device=full.device)
    pos = slots + ((s - 1 - slots) // sc) * sc               # (sc,)
    valid = pos >= 0
    packed = full[:, torch.clamp(pos, min=0)]
    packed = torch.where(valid.reshape(1, sc, *([1] * (full.dim() - 2))),
                         packed, torch.zeros((), dtype=full.dtype,
                                             device=full.device))
    return packed, torch.where(valid, pos, -1).to(torch.int32)


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens, max_len: int, patches=None,
            rules=None):
    """Batched prefill: one full forward that also fills the decode
    cache: every layer's K/V packed into its ring, and, in the hybrid
    family, every Mamba2 layer's SSM state and conv window; in the xLSTM
    family every block's recurrent state.  Returns (cache, logits of the
    last position (B, V)).  ``tokens`` (and ``patches``) may be numpy
    arrays; they move to the parameters' device.  Over a mesh: the global
    batch in, this rank's block of the cache and the global logits
    out."""
    _check_family(cfg, "prefill")
    compute = compute_dtype(cfg)
    dev = params["embed"].device
    lay = _layout(cfg, rules, len(tokens))
    if lay is not None:
        tokens = lay.rows(tokens)
        patches = None if patches is None else lay.rows(patches)
        params = lay.serve_params(params)
    if patches is not None:
        patches = torch.as_tensor(patches, device=dev)
    x = embed_tokens(cfg, params, _as_index(tokens, dev), patches, compute,
                     lay)
    b, s, _ = x.shape
    if cfg.family == "hybrid_ssm":
        ssm.check_length(cfg, s)
        ng, period, tail = _pattern(cfg)
        if not ng:
            raise ValueError(
                f"{cfg.name}: the hybrid pattern of n_layers="
                f"{cfg.n_layers}, attn_every={period} has no group (0 "
                f"groups and {tail} tail Mamba2 layers): no shared "
                "attention block, so no KV ring to fill")
    batch = b if lay is None else lay.batch_size
    cache = init_cache(cfg, batch, max_len, compute, rules, device=dev)
    cache["pos"].fill_(s)
    if cfg.family == "xlstm":
        x = _xlstm_prefill(cfg, params, cache, x, lay)
    else:
        x = _ring_prefill(cfg, params, cache, x, max_len, lay)
    if cfg.family == "hybrid_ssm" and s < cfg.conv_width - 1:
        cache[SHORT_PREFILL] = torch.tensor(s)
    logits = lm_logits(cfg, params, x[:, -1:], lay)[:, 0]
    if lay is not None:
        logits = global_logits(cfg, logits, lay)
    return cache, logits


def _xlstm_prefill(cfg, params, cache, x, lay):
    """The xLSTM family's blocks over the prompt, each writing its state
    into ``cache``."""
    lp = params["layers"]
    ng, nm, nt = _xlstm_stacks(lp)

    def mlstm(p, xx, states, idx):
        h = common.rmsnorm(xx, p["norm"], cfg.norm_eps, cfg.use_pallas)
        y, c, n, m = xlstm.mlstm_forward(cfg, p, h, return_state=True,
                                         lay=lay)
        _store(states, idx, {"c": c, "n": n, "m": m})
        return xx + y

    for g in range(ng):
        sl = layer_slice(lp["mlstm_main"], g)
        for i in range(nm):
            x = mlstm(layer_slice(sl, i), x, cache["mlstm_main"], (g, i))
        if "slstm" in lp:
            p = layer_slice(lp["slstm"], g)
            h = common.rmsnorm(x, p["norm"], cfg.norm_eps, cfg.use_pallas)
            y, (c, n, hs, m) = xlstm.slstm_forward(cfg, p, h,
                                                   return_state=True, lay=lay)
            _store(cache["slstm"], g, {"c": c, "n": n, "h": hs, "m": m})
            x = x + y
    for i in range(nt):
        x = mlstm(layer_slice(lp["mlstm_tail"], i), x, cache["mlstm_tail"],
                  (i,))
    return x


def _ring_prefill(cfg, params, cache, x, max_len: int, lay):
    """The families with a KV ring (dense, MoE, hybrid): every layer over
    the prompt, each packing its K/V (and Mamba2 states) into
    ``cache``."""
    b, s, _ = x.shape
    dev = x.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    sc = cache_len(cfg, max_len)
    batch = b if lay is None else lay.batch_size
    ring = _ring(cfg, lay, batch, sc)
    cs = None if ring is None else ring[0]
    scale = cfg.head_dim ** -0.5
    whole = lay is None or lay.kv is None

    def attn_with_cache(p, xx, i):
        """Attention block that also packs layer i's KV ring."""
        h = common.rmsnorm(xx, p["attn_norm"], cfg.norm_eps, cfg.use_pallas)
        q, k, v = common._qkv_local(cfg, p["attn"], h, positions, lay)
        kr, slot_pos = _ring_pack(common.kv_to_ring(k, lay, ring), sc, s)
        vr, _ = _ring_pack(common.kv_to_ring(v, lay, ring), sc, s)
        if cs is not None:
            kr, vr = cs.local(kr, 1), cs.local(vr, 1)
        cache["k"][i] = kr
        cache["v"][i] = vr
        k, group = common.kv_for_heads(cfg, k, lay, whole)
        v, _ = common.kv_for_heads(cfg, v, lay, whole)
        kk = torch.repeat_interleave(k, group, dim=2)
        vv = torch.repeat_interleave(v, group, dim=2)
        if cfg.attn_impl == "blocked" and s > cfg.q_block:
            o = common.blocked_sdpa(q, kk, vv, positions, cfg.window, scale,
                                    cfg.q_block)
        else:
            mask = common._mask(positions[None], positions[None], cfg.window)
            o = common._sdpa(q, kk, vv, mask, scale)
        o = o.reshape(b, s, q.shape[2] * cfg.head_dim)
        return xx + common.out_proj(o, p["attn"]["wo"], xx.shape[-1],
                                    lay), slot_pos

    lp = params["layers"]

    def mamba_with_state(p, xx, name, idx):
        """A Mamba2 layer that also writes its SSM state and conv
        window."""
        h = common.rmsnorm(xx, p["norm"], cfg.norm_eps, cfg.use_pallas)
        y, st, cst = ssm.ssd_forward(cfg, p, h, return_state=True, lay=lay)
        cache[f"ssm_{name}"][idx] = st
        cache[f"conv_{name}"][idx] = cst
        return xx + y

    def blocks():
        """(kind, index, parameters) of each block in order, each layer's
        taken as it is reached (a ZeRO-extended weight is gathered
        then)."""
        if cfg.family != "hybrid_ssm":
            for i in range(cfg.n_layers):
                yield "block", i, layer_slice(lp, i)
            return
        ng, period, tail = _pattern(cfg)
        for g in range(ng):
            sl = layer_slice(lp["mamba_main"], g)
            for i in range(period):
                yield "main", (g, i), layer_slice(sl, i)
            yield "shared", g, params["shared"]
        for i in range(tail):
            yield "tail", (i,), layer_slice(lp["mamba_tail"], i)

    for kind, i, p in blocks():
        if kind in ("main", "tail"):
            x = mamba_with_state(p, x, kind, i)
            continue
        x, slot_pos = attn_with_cache(p, x, i)
        h = common.rmsnorm(x, p["mlp_norm"], cfg.norm_eps, cfg.use_pallas)
        if cfg.is_moe:
            y, _ = common.moe_ffn(cfg, p["moe"], h, lay)
        else:
            y = common.swiglu(p["mlp"], h, lay)
        x = x + y
    cache["slot_pos"] = slot_pos
    return x
