"""Decoder-only LM, dense and MoE families.  Port of ``repro.models.lm``.

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

Not ported yet, each raising ``NotImplementedError`` that names its item
of ROADMAP.md:

* the ``hybrid_ssm`` family (Zamba2, ``models/ssm.py``) — A13d;
* the ``xlstm`` family (``models/xlstm.py``) — A13e.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.collectives import copy_to, gather_from, reduce_from
from ..device import resolve_device
from . import common
from .layout import gather_batch, layout
from .params import ParamDef, layer_slice, layer_views

#: ROADMAP items of the families the port does not declare yet.
_FAMILY_ITEMS = {"hybrid_ssm": "A13d (models/ssm.py)",
                 "xlstm": "A13e (models/xlstm.py)",
                 "encdec": "A13f (models/encdec.py)"}


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP {item})")


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


def param_defs(cfg: ModelConfig) -> dict:
    if cfg.family not in ("dense", "moe"):
        raise not_ported(f"the {cfg.family!r} family",
                         _FAMILY_ITEMS.get(cfg.family, "A13"))
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


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


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
        x, w = x.to(torch.float32), w.to(torch.float32)
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
    if cfg.family not in ("dense", "moe"):
        raise not_ported(f"forward of the {cfg.family!r} family",
                         _FAMILY_ITEMS.get(cfg.family, "A13"))
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
    for p in layer_views(params["layers"], cfg.n_layers):
        if remat:
            x, aux = checkpoint(_dense_block, cfg, p, x, positions, aux,
                                lay, use_reentrant=False)
        else:
            x, aux = _dense_block(cfg, p, x, positions, aux, lay)
    return lm_logits(cfg, params, x, lay), aux, lay


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


def _check_family(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in ("dense", "moe"):
        raise not_ported(f"{what} of the {cfg.family!r} family",
                         _FAMILY_ITEMS.get(cfg.family, "A13"))


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.window) if cfg.window else max_len


def cache_defs(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Declaration tree of the decode cache (dense and MoE families).
    ``pos`` = tokens consumed; ``k``/``v`` (L, B, Sc, KV, hd) rings;
    ``slot_pos`` (Sc,) the position each slot holds (-1 = empty)."""
    _check_family(cfg, "the decode cache")
    sc = cache_len(cfg, max_len)
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    seq_ax = "long_seq" if batch == 1 else "kv_seq"
    ring = CacheLeaf((cfg.n_layers, batch, sc, kv, hd), dtype, 0,
                     (None, "batch", seq_ax, "kv_heads", None))
    return {"pos": CacheLeaf((), torch.int32, 0, ()),
            "k": ring, "v": ring,
            "slot_pos": CacheLeaf((sc,), torch.int32, -1, (None,))}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, rules=None,
               device=None) -> dict:
    """The cache of :func:`cache_defs`, filled, on ``device`` (default:
    the card; raises without one).  Over a mesh (``rules``): this rank's
    block of each leaf."""
    dev = resolve_device(device)
    out = {}
    for name, leaf in cache_defs(cfg, batch, max_len, dtype).items():
        shape = leaf.shape
        if rules is not None:
            shape = rules.sharding(leaf.axes, shape).local_shape(shape)
        out[name] = torch.full(shape, leaf.fill, dtype=leaf.dtype,
                               device=dev)
    return out


def cache_structs(*args, **kwargs):
    """The sharded dry-run cache: ROADMAP A13g."""
    raise not_ported("cache_structs (the sharded dry-run cache)", "A13g")


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
    the K/V rings and ``slot_pos`` are written in place, ``pos`` is a new
    tensor one larger.  Over a mesh: the global tokens in, this rank's
    block of the cache, the global logits out."""
    _check_family(cfg, "decode_step")
    dev = params["embed"].device
    lay = _layout(cfg, rules, len(tokens))
    if lay is not None:
        tokens = lay.rows(tokens)
    tokens = _as_index(tokens, dev)
    pos = int(cache["pos"])                  # the step's one host read
    slot_pos = cache["slot_pos"]
    ring = _ring(cfg, lay, lay.batch_size if lay else 0, slot_pos.shape[0])
    emb = params["embed"]
    if lay is not None:
        emb = gather_from(lay.embed_fsdp, emb, 1)
    x = _lookup(emb, tokens, lay).to(compute_dtype(cfg))[:, None]  # (B,1,D)
    lp = params["layers"]
    for i in range(cfg.n_layers):
        x, _, _, slot_pos = _attn_block_decode(
            cfg, layer_slice(lp, i), x, cache["k"][i], cache["v"][i],
            slot_pos, pos, lay, ring)
    logits = lm_logits(cfg, params, x, lay)[:, 0]
    if lay is not None:
        logits = global_logits(cfg, logits, lay)
    return dict(cache, pos=cache["pos"] + 1), logits


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
    """Batched prefill: one full forward that also packs every layer's K/V
    into the ring cache.  Returns (cache, logits of the last position
    (B, V)).  ``tokens`` (and ``patches``) may be numpy arrays; they move
    to the parameters' device.  Over a mesh: the global batch in, this
    rank's block of the cache and the global logits out."""
    _check_family(cfg, "prefill")
    compute = compute_dtype(cfg)
    dev = params["embed"].device
    lay = _layout(cfg, rules, len(tokens))
    if lay is not None:
        tokens = lay.rows(tokens)
        patches = None if patches is None else lay.rows(patches)
    if patches is not None:
        patches = torch.as_tensor(patches, device=dev)
    x = embed_tokens(cfg, params, _as_index(tokens, dev), patches, compute,
                     lay)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    sc = cache_len(cfg, max_len)
    batch = b if lay is None else lay.batch_size
    cache = init_cache(cfg, batch, max_len, compute, rules, device=dev)
    ring = _ring(cfg, lay, batch, sc)
    cs = None if ring is None else ring[0]
    cache["pos"].fill_(s)
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
    for i in range(cfg.n_layers):
        p = layer_slice(lp, i)
        x, slot_pos = attn_with_cache(p, x, i)
        h = common.rmsnorm(x, p["mlp_norm"], cfg.norm_eps, cfg.use_pallas)
        if cfg.is_moe:
            y, _ = common.moe_ffn(cfg, p["moe"], h, lay)
        else:
            y = common.swiglu(p["mlp"], h, lay)
        x = x + y
    cache["slot_pos"] = slot_pos
    logits = lm_logits(cfg, params, x[:, -1:], lay)[:, 0]
    if lay is not None:
        logits = global_logits(cfg, logits, lay)
    return cache, logits
