"""Encoder-decoder transformer (seamless-m4t): a speech encoder over
precomputed fbank frames (a linear adapter: the stub frontend) and a text
decoder with cross-attention.  Port of ``repro.models.encdec``.

Train: (frames (B,Se,frontend_dim), tokens (B,Sd)) -> next-token loss.
Serve: ``prefill`` encodes the frames once and runs the decoder over the
prompt, filling a cache of the decoder's self-attention K/V ring and each
decoder layer's fixed cross-attention K/V of the encoder output; then
``decode_step`` one token per sequence against it.  ``serve.ServeEngine``
passes tokens only, as the JAX package's does, so it refuses this family.

The numbers are the JAX package's: the frames cast to the compute dtype
before the adapter; the encoder's RoPE at positions ``0..Se-1`` and its
bidirectional attention through ``common._sdpa`` under an all-true mask;
``enc_out_norm``, then each decoder layer's cross K/V from the normed
output (no RoPE on the cross path); the cross attention's scores and
softmax in float32 with no mask, its probabilities not rounded before the
product with V; the decoder's logits as one product in the compute dtype,
then cast to float32 (``logits_fp32`` in ``forward``; always in
``prefill`` and ``decode_step``).  Layers run as Python loops over the
stacked parameters (``params.layer_views`` in ``forward``, with
``cfg.remat == "block"`` each encoder and decoder block recomputed in the
backward; ``params.layer_slice`` in ``prefill`` and ``decode_step``).

Kernels, as in ``models.lm``: every RMSNorm passes
``use_pallas=cfg.use_pallas`` (the ``rmsnorm`` kernel); ``forward``'s
decoder self-attention is ``common.attention`` under ``cfg.attn_impl``
(``"pallas"``: ``flash_attention``, causal) and ``decode_step``'s is
``common.attention_decode`` over the ring (``"pallas"``:
``decode_attention``).  The encoder's attention, the cross attention and
``prefill``'s decoder attention (``_sdpa`` under the causal mask, never
blocked) are plain PyTorch, as they are plain XLA in the JAX package.

The cache holds ``pos``, ``k``/``v`` (L, B, Sc, KV, hd) and ``slot_pos``
as ``models.lm``'s ring, and ``cross_k``/``cross_v`` (L, B, Se, KV, hd):
``init_cache`` makes them ``frontend_len`` long, ``prefill`` as long as
the frames.  ``decode_step`` writes the ring in place and reads ``pos`` on
the host once per step.

Over a device mesh (``rules``) the encoder's and decoder's attention+MLP
blocks and the cross block are tensor-parallel as the decoder-only blocks
are (``wq`` by heads, ``wk``/``wv`` by KV heads, ``wo`` row-parallel with
a ``psum``, the MLP's ``ff`` columns), ``embed``/``lm_head``
vocab-parallel, and the frames split with the batch.  The cross cache is
declared on ``kv_seq`` x ``kv_heads``, which map to the same mesh axes, so
it holds each rank's block of the frames (its KV heads whole) where the
frames divide, else its KV heads: ``decode_step``'s cross attention then
gathers the query to every head, attends over its frames and combines the
ranks' partial softmaxes, as ``common.attention_decode``'s split slots do.
On a ``(1, 1)`` mesh every collective is the identity, bit for bit.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.collectives import copy_to, gather_from, reduce_from
from . import common, lm
from .layout import layout
from .params import ParamDef, layer_slice, layer_views


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _attn_defs(cfg: ModelConfig, stack: tuple) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sa = ("layers",) * len(stack)
    return {
        "wq": ParamDef(stack + (d, h, hd), sa + (None, "heads", None)),
        "wk": ParamDef(stack + (d, kv, hd), sa + (None, "kv_heads", None)),
        "wv": ParamDef(stack + (d, kv, hd), sa + (None, "kv_heads", None)),
        "wo": ParamDef(stack + (h * hd, d), sa + ("heads", None)),
    }


def param_defs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab_size
    le, ld = cfg.enc_layers, cfg.n_layers
    return {
        "embed": ParamDef((v, d), ("vocab", "embed"), "normal", 1.0),
        "frontend_adapter": ParamDef((cfg.frontend_dim, d), (None, "embed")),
        "enc_out_norm": ParamDef((d,), (None,), "ones"),
        "out_norm": ParamDef((d,), (None,), "ones"),
        "lm_head": ParamDef((d, v), ("embed", "vocab")),
        "encoder": {
            "attn_norm": ParamDef((le, d), ("layers", None), "ones"),
            "attn": _attn_defs(cfg, (le,)),
            "mlp_norm": ParamDef((le, d), ("layers", None), "ones"),
            "mlp": lm._mlp_defs(cfg, (le,)),
        },
        "decoder": {
            "attn_norm": ParamDef((ld, d), ("layers", None), "ones"),
            "attn": _attn_defs(cfg, (ld,)),
            "cross_norm": ParamDef((ld, d), ("layers", None), "ones"),
            "cross": _attn_defs(cfg, (ld,)),
            "mlp_norm": ParamDef((ld, d), ("layers", None), "ones"),
            "mlp": lm._mlp_defs(cfg, (ld,)),
        },
    }


def _layout(cfg: ModelConfig, rules, batch: int):
    return layout(cfg, rules, batch, param_defs)


def _norm(cfg: ModelConfig, x, scale):
    return common.rmsnorm(x, scale, cfg.norm_eps, cfg.use_pallas)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _cross_kv(cfg: ModelConfig, p, x: torch.Tensor, lay=None):
    """One decoder layer's cross K/V (B,Se,KVh,hd) of the encoder output x
    (B,Se,D): this rank's KV heads (all of them where ``wk`` is whole)."""
    heads = None if lay is None else lay.heads
    wk, wv = p["wk"].to(x.dtype), p["wv"].to(x.dtype)
    if heads is not None:
        x = copy_to(heads, x)
        if lay.kv is None:                # replicated KV weights
            wk, wv = copy_to(heads, wk), copy_to(heads, wv)
    return (torch.einsum("bsd,dhk->bshk", x, wk),
            torch.einsum("bsd,dhk->bshk", x, wv))


def _self_attention(cfg: ModelConfig, p, h: torch.Tensor,
                    positions: torch.Tensor, mask: torch.Tensor, lay=None):
    """``common._sdpa`` attention of h (B,S,D) under ``mask`` (1,S,S) and
    the output projection (the encoder's, and ``prefill``'s decoder's);
    -> (out, k, v), k/v (B,S,KVh,hd) as computed."""
    b, s, d = h.shape
    q, k, v = common._qkv_local(cfg, p, h, positions, lay)
    whole = lay is None or lay.kv is None
    kk, group = common.kv_for_heads(cfg, k, lay, whole)
    vv, _ = common.kv_for_heads(cfg, v, lay, whole)
    kk = torch.repeat_interleave(kk, group, dim=2)
    vv = torch.repeat_interleave(vv, group, dim=2)
    o = common._sdpa(q, kk, vv, mask, cfg.head_dim ** -0.5)
    o = o.reshape(b, s, q.shape[2] * cfg.head_dim)
    return common.out_proj(o, p["wo"], d, lay), k, v


def _enc_block(cfg: ModelConfig, p, x, positions, mask, lay=None):
    h = _norm(cfg, x, p["attn_norm"])
    x = x + _self_attention(cfg, p["attn"], h, positions, mask, lay)[0]
    h = _norm(cfg, x, p["mlp_norm"])
    return x + common.swiglu(p["mlp"], h, lay)


def encode(cfg: ModelConfig, params, frames: torch.Tensor, lay=None):
    """frames (B,Se,frontend_dim) (this rank's rows over a mesh) -> the
    encoder output (B,Se,D) and every decoder layer's cross K/V
    (Ld,B,Se,KVh,hd) in the compute dtype."""
    compute = lm.compute_dtype(cfg)
    adapter = params["frontend_adapter"].to(compute)
    if lay is not None:
        adapter = gather_from(lay.adapter_fsdp, adapter, 1,
                              lay.reduce_for(lay.adapter_fsdp))
    x = torch.einsum("bsf,fd->bsd", frames.to(compute), adapter)
    se = x.shape[1]
    positions = torch.arange(se, dtype=torch.int32, device=x.device)
    mask = torch.ones((1, se, se), dtype=torch.bool, device=x.device)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for p in layer_views(params["encoder"], cfg.enc_layers):
        if remat:
            x = checkpoint(_enc_block, cfg, p, x, positions, mask, lay,
                           use_reentrant=False)
        else:
            x = _enc_block(cfg, p, x, positions, mask, lay)
    x = _norm(cfg, x, params["enc_out_norm"])
    pairs = [_cross_kv(cfg, p, x, lay)
             for p in layer_views(params["decoder"]["cross"], cfg.n_layers)]
    return (x, torch.stack([k for k, _ in pairs]),
            torch.stack([v for _, v in pairs]))


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _cross_attention(cfg: ModelConfig, p, x: torch.Tensor,
                     enc_k: torch.Tensor, enc_v: torch.Tensor, lay=None,
                     cross=None) -> torch.Tensor:
    """x (B,Sq,D) queries against precomputed encoder K/V (B,Se,KVh,hd):
    float32 scores and softmax, no mask.

    ``cross`` (the cache's (frame, KV-head) collectives, ``None`` where
    ``enc_k`` is this rank's KV heads as :func:`encode` computes them):
    where the frames are split, each rank attends over its own and the
    ranks combine their partial softmaxes (the ``pmax`` of the maxima,
    the ``psum`` of the sums and of the values), the query gathered to
    every head first where the frames and the heads share axes."""
    b, sq, d = x.shape
    heads = None if lay is None else lay.heads
    cs = None if cross is None else cross[0]
    q = torch.einsum("bsd,dhk->bshk", copy_to(heads, x),
                     p["wq"].to(x.dtype))
    all_heads = (cs is not None and heads is not None
                 and bool(set(cs.axes) & set(heads.axes)))
    if all_heads:
        q = heads.all_gather(q, 2)
    whole = (lay is None or lay.kv is None if cross is None
             else cross[1] is None)
    kk, group = common.kv_for_heads(cfg, enc_k, lay, whole, all_heads)
    vv, _ = common.kv_for_heads(cfg, enc_v, lay, whole, all_heads)
    if group > 1:
        kk = torch.repeat_interleave(kk, group, dim=2)
        vv = torch.repeat_interleave(vv, group, dim=2)
    f32 = common.wide(x.dtype)
    s = torch.einsum("bqhk,bthk->bhqt", q.to(f32),
                     kk.to(x.dtype).to(f32)) * cfg.head_dim ** -0.5
    if cs is None:
        a = torch.softmax(s, dim=-1)
    else:
        e = torch.exp(s - cs.pmax(s.amax(-1, keepdim=True)))
        a = e / cs.psum(e.sum(-1, keepdim=True))
    o = torch.einsum("bhqt,bthk->bqhk", a, vv.to(x.dtype).to(f32))
    if cs is not None:
        o = cs.psum(o)
    o = o.to(x.dtype).reshape(b, sq, q.shape[2] * cfg.head_dim)
    return common.out_proj(o, p["wo"], d, lay, all_heads)


def _dec_block(cfg: ModelConfig, p, x, positions, cross_k, cross_v,
               lay=None):
    h = _norm(cfg, x, p["attn_norm"])
    x = x + common.attention(cfg, p["attn"], h, positions,
                             impl=cfg.attn_impl, q_block=cfg.q_block,
                             lay=lay)
    h = _norm(cfg, x, p["cross_norm"])
    x = x + _cross_attention(cfg, p["cross"], h, cross_k, cross_v, lay)
    h = _norm(cfg, x, p["mlp_norm"])
    return x + common.swiglu(p["mlp"], h, lay)


def _logits(cfg: ModelConfig, params, x: torch.Tensor, lay, fp32: bool):
    """``out_norm`` and the head as one product in x's dtype, then (``fp32``)
    cast: the JAX function's order (``models.lm.lm_logits`` takes
    float32 operands instead).  Over a mesh whose vocabulary is split,
    this rank's block of it."""
    x = _norm(cfg, x, params["out_norm"])
    w = params["lm_head"].to(x.dtype)
    if lay is not None:
        w = gather_from(lay.head_fsdp, w, 0, lay.reduce_for(lay.head_fsdp))
        x = copy_to(lay.head_vocab, x)
    logits = torch.einsum("bsd,dv->bsv", x, w)
    return logits.to(common.wide(x.dtype)) if fp32 else logits


def _inputs(cfg: ModelConfig, params, batch: dict, rules):
    """(layout, frames, tokens) of this rank's rows of a global batch,
    on the parameters' device."""
    dev = params["embed"].device
    tokens, frames = batch["tokens"], batch["frames"]
    lay = _layout(cfg, rules, len(tokens))
    if lay is not None:
        tokens, frames = lay.rows(tokens), lay.rows(frames)
    return (lay, torch.as_tensor(frames, device=dev),
            lm._as_index(tokens, dev))


def _forward(cfg: ModelConfig, params, batch: dict, rules=None):
    """The forward on this rank's rows -> (logits block, layout)."""
    lay, frames, tokens = _inputs(cfg, params, batch, rules)
    _, cross_k, cross_v = encode(cfg, params, frames, lay)
    x = lm.embed_tokens(cfg, params, tokens, None, lm.compute_dtype(cfg),
                        lay)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for p, ck, cv in zip(layer_views(params["decoder"], cfg.n_layers),
                         cross_k.unbind(0), cross_v.unbind(0)):
        if remat:
            x = checkpoint(_dec_block, cfg, p, x, positions, ck, cv, lay,
                           use_reentrant=False)
        else:
            x = _dec_block(cfg, p, x, positions, ck, cv, lay)
    return _logits(cfg, params, x, lay, cfg.logits_fp32), lay


def forward(cfg: ModelConfig, params, batch: dict, rules=None):
    """Training forward over ``batch`` ({"frames", "tokens"}, numpy or
    tensors) -> (logits (B,Sd,V), aux 0).  Over a mesh: the global batch
    in, the global logits out (gathered, with no backward)."""
    logits, lay = _forward(cfg, params, batch, rules)
    if lay is not None:
        logits = lm.global_logits(cfg, logits, lay)
    return logits, torch.zeros((), dtype=torch.float32,
                               device=logits.device)


def loss_fn(cfg: ModelConfig, params, batch: dict, rules=None):
    """Next-token cross entropy over ``batch`` ({"frames", "tokens",
    "labels"}); label -100 is ignored -> (loss, {"nll", "aux"}), aux 0:
    the mean over the valid labels (at least one) of the fp32
    log-softmax's negative log-likelihood.  Over a mesh: the sum and the
    count of the global batch, a vocab-parallel cross entropy where the
    vocabulary is split."""
    logits, lay = _forward(cfg, params, batch, rules)
    labels = batch["labels"]
    if lay is not None:
        labels = lay.rows(labels)
    labels = lm._as_index(labels, logits.device)
    valid = labels >= 0
    safe = torch.clamp(labels, min=0)
    vocab = None if lay is None else lay.head_vocab
    if vocab is None:
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(lp, -1, safe[..., None])[..., 0]
    else:
        nll = lm._vocab_parallel_nll(logits, safe, vocab)
    rows = None if lay is None else lay.batch
    total = reduce_from(rows, torch.sum(nll * valid))
    count = valid.sum() if rows is None else rows.psum(valid.sum())
    loss = total / torch.clamp(count, min=1)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache = decoder self-KV ring + fixed cross K/V
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               frames: int = None) -> dict:
    """Declaration tree of the cache: ``models.lm``'s ring (``pos``,
    ``k``/``v`` (L, B, Sc, KV, hd) on ``long_seq`` when the batch is 1
    and ``kv_seq`` otherwise, ``slot_pos``) and ``cross_k``/``cross_v``
    (L, B, ``frames`` (default ``frontend_len``), KV, hd), always on
    ``kv_seq``."""
    sc = lm.cache_len(cfg, max_len)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    n, se = cfg.n_layers, cfg.frontend_len if frames is None else frames
    seq_ax = "long_seq" if batch == 1 else "kv_seq"
    leaf = lm.CacheLeaf
    return {
        "pos": leaf((), torch.int32, 0, ()),
        "k": leaf((n, batch, sc, kv, hd), dtype, 0,
                  (None, "batch", seq_ax, "kv_heads", None)),
        "v": leaf((n, batch, sc, kv, hd), dtype, 0,
                  (None, "batch", seq_ax, "kv_heads", None)),
        "slot_pos": leaf((sc,), torch.int32, -1, (None,)),
        "cross_k": leaf((n, batch, se, kv, hd), dtype, 0,
                        (None, "batch", "kv_seq", "kv_heads", None)),
        "cross_v": leaf((n, batch, se, kv, hd), dtype, 0,
                        (None, "batch", "kv_seq", "kv_heads", None)),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, rules=None,
               device=None) -> dict:
    """The cache of :func:`cache_defs`, filled, on ``device`` (default:
    the card); over a mesh this rank's block of each leaf."""
    return lm.fill_cache(cache_defs(cfg, batch, max_len, dtype), rules,
                         device)


def cache_structs(cfg: ModelConfig, batch: int, max_len: int, rules,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """The dry run's stand-ins of the cache (``lm.structs_of_cache``):
    the ring and ``frontend_len`` frames of cross K/V."""
    return lm.structs_of_cache(cache_defs(cfg, batch, max_len, dtype),
                               rules, max_len)


def _ring(cfg: ModelConfig, lay, sc: int):
    """The self ring's (slot, KV-head) collectives, ``None`` without a
    mesh."""
    if lay is None:
        return None
    return lay.cache(cache_defs(cfg, lay.batch_size, sc))


def _cross_layout(cfg: ModelConfig, lay, frames: int):
    """The cross cache's (frame, KV-head) collectives for ``frames``
    frames, ``None`` without a mesh."""
    if lay is None:
        return None
    return lay.cache(cache_defs(cfg, lay.batch_size, 1, frames=frames),
                     "cross_k")


def _cross_of_block(cfg: ModelConfig, lay, block: torch.Tensor):
    """The cross cache's collectives from this rank's block (L, Bl, Sel,
    KVl, hd) of it: the global frame count is ``Sel`` or ``Sel`` times the
    size of ``kv_seq``'s axes, whichever lays out to this block."""
    if lay is None:
        return None
    sel = block.shape[2]
    size = lay.rules.comm(lay.rules.spec(("kv_seq",)).axes(0)).size
    fits = []
    for se in sorted({sel, sel * size}):
        d = cache_defs(cfg, lay.batch_size, 1, frames=se)["cross_k"]
        if lay.rules.sharding(d.axes, d.shape).local_shape(
                d.shape) == tuple(block.shape):
            fits.append(se)
    if len(fits) != 1:
        raise ValueError(f"a cross cache block {tuple(block.shape)} fits "
                         f"the layouts of {fits} frames")
    return _cross_layout(cfg, lay, fits[0])


def _to_cross_cache(t: torch.Tensor, lay, cross) -> torch.Tensor:
    """Every layer's cross K/V (L,B,Se,KVh,hd) as :func:`encode` computes
    them in the cross cache's layout ``cross`` (frame, KV-head
    collectives): its KV heads, then this rank's frames."""
    if lay is None:
        return t
    t = common.kv_to_ring(t, lay, cross, dim=3)
    return t if cross[0] is None else cross[0].local(t, 2)


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache: dict, tokens, rules=None):
    """One decoder token for all sequences; the cross K/V fixed in the
    cache.  tokens (B,) ints -> (cache, logits (B, V) float32): the ring
    and ``slot_pos`` are written in place, ``pos`` is a new tensor one
    larger.  Over a mesh: the global tokens in, this rank's block of the
    cache, the global logits out."""
    dev = params["embed"].device
    lay = _layout(cfg, rules, len(tokens))
    if lay is not None:
        tokens = lay.rows(tokens)
        params = lay.serve_params(params)
    tokens = lm._as_index(tokens, dev)
    emb = params["embed"]
    if lay is not None:
        emb = gather_from(lay.embed_fsdp, emb, 1)
    x = lm._lookup(emb, tokens, lay).to(lm.compute_dtype(cfg))[:, None]
    pos = int(cache["pos"])                  # the step's one host read
    slot_pos = cache["slot_pos"]
    ring = _ring(cfg, lay, slot_pos.shape[0])
    cross = _cross_of_block(cfg, lay, cache["cross_k"])
    dp = params["decoder"]
    for i in range(cfg.n_layers):
        p = layer_slice(dp, i)
        h = _norm(cfg, x, p["attn_norm"])
        y, _, _, slot_pos = common.attention_decode(
            cfg, p["attn"], h, cache["k"][i], cache["v"][i], slot_pos, pos,
            lay, ring)
        x = x + y
        h = _norm(cfg, x, p["cross_norm"])
        x = x + _cross_attention(cfg, p["cross"], h, cache["cross_k"][i],
                                 cache["cross_v"][i], lay, cross)
        h = _norm(cfg, x, p["mlp_norm"])
        x = x + common.swiglu(p["mlp"], h, lay)
    logits = _logits(cfg, params, x, lay, True)[:, 0]
    if lay is not None:
        logits = lm.global_logits(cfg, logits, lay)
    return dict(cache, pos=cache["pos"] + 1), logits


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch_inputs: dict, max_len: int,
            rules=None):
    """Encode ``batch_inputs["frames"]`` and run the decoder over the
    prompt ``batch_inputs["tokens"]`` (numpy or tensors) -> (cache,
    logits of the last position (B, V) float32): every decoder layer's
    K/V packed into its ring (``lm._ring_pack``; ``slot_pos`` from the
    last layer) and its cross K/V, as long as the frames, in the compute
    dtype.  The decoder's prompt attention is ``common._sdpa`` under the
    causal (window) mask.  Over a mesh: the global batch in, this rank's
    block of the cache and the global logits out."""
    compute = lm.compute_dtype(cfg)
    lay, frames, tokens = _inputs(cfg, params, batch_inputs, rules)
    if lay is not None:
        params = lay.serve_params(params)
    _, cross_k, cross_v = encode(cfg, params, frames, lay)
    x = lm.embed_tokens(cfg, params, tokens, None, compute, lay)
    b, sd, _ = x.shape
    dev = x.device
    positions = torch.arange(sd, dtype=torch.int32, device=dev)
    sc = lm.cache_len(cfg, max_len)
    batch = b if lay is None else lay.batch_size
    se = frames.shape[1]
    ring = _ring(cfg, lay, sc)
    cross = _cross_layout(cfg, lay, se)
    defs = cache_defs(cfg, batch, max_len, compute, frames=se)
    cache = lm.fill_cache({k: defs[k] for k in ("pos", "k", "v")}, rules,
                          dev)
    cache["pos"].fill_(sd)
    mask = common._mask(positions[None], positions[None], cfg.window)
    cs = None if ring is None else ring[0]
    slot_pos = None
    for i in range(cfg.n_layers):
        p = layer_slice(params["decoder"], i)
        h = _norm(cfg, x, p["attn_norm"])
        y, k, v = _self_attention(cfg, p["attn"], h, positions, mask, lay)
        kr, slot_pos = lm._ring_pack(common.kv_to_ring(k, lay, ring), sc, sd)
        vr, _ = lm._ring_pack(common.kv_to_ring(v, lay, ring), sc, sd)
        if cs is not None:
            kr, vr = cs.local(kr, 1), cs.local(vr, 1)
        cache["k"][i] = kr
        cache["v"][i] = vr
        x = x + y
        h = _norm(cfg, x, p["cross_norm"])
        x = x + _cross_attention(cfg, p["cross"], h, cross_k[i], cross_v[i],
                                 lay)
        h = _norm(cfg, x, p["mlp_norm"])
        x = x + common.swiglu(p["mlp"], h, lay)
    cache["slot_pos"] = slot_pos
    cache["cross_k"] = _to_cross_cache(cross_k.to(compute), lay, cross)
    cache["cross_v"] = _to_cross_cache(cross_v.to(compute), lay, cross)
    logits = _logits(cfg, params, x[:, -1:], lay, True)[:, 0]
    if lay is not None:
        logits = lm.global_logits(cfg, logits, lay)
    return cache, logits
