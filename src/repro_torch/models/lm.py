"""Decoder-only LM, dense and MoE families.  Port of ``repro.models.lm``.

One parameter-declaration table per family (``param_defs``) and one
forward for prefill-style full sequences (``forward``).  Layers run as a
Python loop over the stacked parameters (the JAX package's ``lax.scan``);
there is no remat, since the port's model slice runs no backward.

Not ported yet, each raising ``NotImplementedError`` that names its item
of ROADMAP.md:

* the ``hybrid_ssm`` family (Zamba2, ``models/ssm.py``) — A13d;
* the ``xlstm`` family (``models/xlstm.py``) — A13e;
* ``loss_fn`` (training) — A13b;
* ``prefill``, ``decode_step`` and the decode cache (serving) — A13a.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
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
    h = common.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    x = x + common.attention(cfg, p["attn"], h, positions,
                             impl=cfg.attn_impl, q_block=cfg.q_block)
    h = common.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
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
    x = common.rmsnorm(x, params["out_norm"], cfg.norm_eps)
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


def prefill(cfg: ModelConfig, params, tokens, max_len: int, patches=None,
            rules=None):
    raise not_ported("prefill (serving)", "A13a")


def decode_step(cfg: ModelConfig, params, cache, tokens, rules=None):
    raise not_ported("decode_step (serving)", "A13a")
