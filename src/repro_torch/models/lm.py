"""Decoder-only LM, dense and MoE families.  Port of ``repro.models.lm``.

One parameter-declaration table per family (``param_defs``), one forward
for full sequences (``forward``), and serving: ``prefill`` (one full
forward that also packs each layer's K/V into a ring cache) and
``decode_step`` (one token per sequence against that cache).  Layers run
as a Python loop over the stacked parameters (the JAX package's
``lax.scan``); there is no remat, since the port's model slice runs no
backward.

Every RMSNorm passes ``use_pallas=cfg.use_pallas`` (True: the ``rmsnorm``
kernel).  Decode attention follows ``cfg.attn_impl`` (``"pallas"``: the
``decode_attention`` kernel; ``common.attention_decode``).  Prefill
attention is the JAX package's: ``common._sdpa``, or
``common.blocked_sdpa`` when ``attn_impl == "blocked"`` and the prompt is
longer than ``q_block``; it never calls ``flash_attention``.
``decode_step`` writes the cache's K/V tensors in place and reads its
``pos`` on the host once per step.

Not ported yet, each raising ``NotImplementedError`` that names its item
of ROADMAP.md:

* the ``hybrid_ssm`` family (Zamba2, ``models/ssm.py``) — A13d;
* the ``xlstm`` family (``models/xlstm.py``) — A13e;
* ``loss_fn`` (training) — A13b;
* serving over a device mesh (``rules``) — A13c.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import common
from .params import ParamDef, layer_slice

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

def _dense_block(cfg, p, x, positions, aux, rules=None):
    h = common.rmsnorm(x, p["attn_norm"], cfg.norm_eps, cfg.use_pallas)
    x = x + common.attention(cfg, p["attn"], h, positions,
                             impl=cfg.attn_impl, q_block=cfg.q_block)
    h = common.rmsnorm(x, p["mlp_norm"], cfg.norm_eps, cfg.use_pallas)
    if cfg.is_moe:
        y, a = common.moe_ffn(cfg, p["moe"], h, rules)
        aux = aux + a
    else:
        y = common.swiglu(p["mlp"], h)
    return x + y, aux


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def embed_tokens(cfg: ModelConfig, params, tokens, patches=None,
                 compute_dtype=torch.bfloat16):
    """tokens (B,St) [+ patches (B,Fl,frontend_dim)] -> x (B,S,D)."""
    emb = params["embed"].to(compute_dtype)
    x = emb[tokens]
    if cfg.frontend == "patch":
        if patches is None:
            raise ValueError(f"{cfg.name} takes patch embeddings")
        pe = torch.einsum("bpf,fd->bpd", patches.to(compute_dtype),
                          params["frontend_adapter"].to(compute_dtype))
        x = torch.cat([pe, x], dim=1)
    return x


def lm_logits(cfg: ModelConfig, params, x):
    x = common.rmsnorm(x, params["out_norm"], cfg.norm_eps, cfg.use_pallas)
    w = (params["embed"] if cfg.tie_embeddings
         else params["lm_head"]).to(x.dtype)
    if cfg.logits_fp32:      # preferred_element_type=float32
        x, w = x.to(torch.float32), w.to(torch.float32)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, w)
    return torch.einsum("bsd,dv->bsv", x, w)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _as_index(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int64)
    return torch.as_tensor(tokens, dtype=torch.int64, device=device)


@torch.no_grad()
def forward(cfg: ModelConfig, params, tokens, patches=None,
            positions=None, rules=None):
    """Full-sequence forward -> (logits (B,S,V), aux_loss scalar).
    ``tokens`` (and ``patches``) may be numpy arrays; they move to the
    parameters' device."""
    if cfg.family not in ("dense", "moe"):
        raise not_ported(f"forward of the {cfg.family!r} family",
                         _FAMILY_ITEMS.get(cfg.family, "A13"))
    dev = params["embed"].device
    if patches is not None:
        patches = torch.as_tensor(patches, device=dev)
    x = embed_tokens(cfg, params, _as_index(tokens, dev), patches,
                     compute_dtype(cfg))
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=dev)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    lp = params["layers"]
    for i in range(cfg.n_layers):
        x, aux = _dense_block(cfg, layer_slice(lp, i), x, positions, aux,
                              rules)
    return lm_logits(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch, rules=None):
    raise not_ported("loss_fn (training)", "A13b")


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

class CacheLeaf(NamedTuple):
    """Cache-leaf declaration: shape, dtype, fill, and the JAX package's
    logical axes (names only: the port shards nothing yet)."""
    shape: tuple
    dtype: torch.dtype
    fill: Any
    axes: tuple


def _check_family(cfg: ModelConfig, what: str) -> None:
    if cfg.family not in ("dense", "moe"):
        raise not_ported(f"{what} of the {cfg.family!r} family",
                         _FAMILY_ITEMS.get(cfg.family, "A13"))


def _check_rules(rules, what: str) -> None:
    if rules is not None:
        raise not_ported(f"{what} over a device mesh", "A13c")


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
    the card; raises without one)."""
    _check_rules(rules, "init_cache")
    dev = resolve_device(device)
    return {name: torch.full(leaf.shape, leaf.fill, dtype=leaf.dtype,
                             device=dev)
            for name, leaf in cache_defs(cfg, batch, max_len,
                                         dtype).items()}


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------

def _attn_block_decode(cfg, p, x, kc, vc, slot_pos, pos: int):
    h = common.rmsnorm(x, p["attn_norm"], cfg.norm_eps, cfg.use_pallas)
    y, kc, vc, slot_pos = common.attention_decode(
        cfg, p["attn"], h, kc, vc, slot_pos, pos)
    x = x + y
    h = common.rmsnorm(x, p["mlp_norm"], cfg.norm_eps, cfg.use_pallas)
    if cfg.is_moe:
        y, _ = common.moe_ffn(cfg, p["moe"], h)
    else:
        y = common.swiglu(p["mlp"], h)
    return x + y, kc, vc, slot_pos


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens, rules=None):
    """One decode step for all sequences. tokens (B,) ints (a tensor or
    anything ``torch.as_tensor`` takes).  Returns (cache, logits (B, V)):
    the K/V rings and ``slot_pos`` are written in place, ``pos`` is a new
    tensor one larger."""
    _check_family(cfg, "decode_step")
    _check_rules(rules, "decode_step")
    dev = params["embed"].device
    tokens = _as_index(tokens, dev)
    x = params["embed"][tokens].to(compute_dtype(cfg))[:, None]  # (B,1,D)
    pos = int(cache["pos"])                  # the step's one host read
    slot_pos = cache["slot_pos"]
    lp = params["layers"]
    for i in range(cfg.n_layers):
        x, _, _, slot_pos = _attn_block_decode(
            cfg, layer_slice(lp, i), x, cache["k"][i], cache["v"][i],
            slot_pos, pos)
    return dict(cache, pos=cache["pos"] + 1), lm_logits(cfg, params, x)[:, 0]


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
    to the parameters' device."""
    _check_family(cfg, "prefill")
    _check_rules(rules, "prefill")
    compute = compute_dtype(cfg)
    dev = params["embed"].device
    if patches is not None:
        patches = torch.as_tensor(patches, device=dev)
    x = embed_tokens(cfg, params, _as_index(tokens, dev), patches, compute)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=dev)
    sc = cache_len(cfg, max_len)
    cache = init_cache(cfg, b, max_len, compute, device=dev)
    cache["pos"].fill_(s)
    group = cfg.n_heads // cfg.n_kv_heads
    scale = cfg.head_dim ** -0.5

    def attn_with_cache(p, xx, i):
        """Attention block that also packs layer i's KV ring."""
        h = common.rmsnorm(xx, p["attn_norm"], cfg.norm_eps, cfg.use_pallas)
        q, k, v = common._qkv(cfg, p["attn"], h, positions)
        kr, slot_pos = _ring_pack(k, sc, s)
        vr, _ = _ring_pack(v, sc, s)
        cache["k"][i] = kr
        cache["v"][i] = vr
        kk = torch.repeat_interleave(k, group, dim=2)
        vv = torch.repeat_interleave(v, group, dim=2)
        if cfg.attn_impl == "blocked" and s > cfg.q_block:
            o = common.blocked_sdpa(q, kk, vv, positions, cfg.window, scale,
                                    cfg.q_block)
        else:
            mask = common._mask(positions[None], positions[None], cfg.window)
            o = common._sdpa(q, kk, vv, mask, scale)
        o = o.reshape(b, s, cfg.n_heads * cfg.head_dim)
        y = torch.einsum("bse,ed->bsd", o, p["attn"]["wo"].to(xx.dtype)
                         .reshape(-1, xx.shape[-1]))
        return xx + y, slot_pos

    lp = params["layers"]
    for i in range(cfg.n_layers):
        p = layer_slice(lp, i)
        x, slot_pos = attn_with_cache(p, x, i)
        h = common.rmsnorm(x, p["mlp_norm"], cfg.norm_eps, cfg.use_pallas)
        if cfg.is_moe:
            y, _ = common.moe_ffn(cfg, p["moe"], h)
        else:
            y = common.swiglu(p["mlp"], h)
        x = x + y
    cache["slot_pos"] = slot_pos
    return cache, lm_logits(cfg, params, x[:, -1:])[:, 0]
