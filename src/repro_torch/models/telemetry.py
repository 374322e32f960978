"""Model telemetry: expose internal routing decisions as mineable
relations (the paper-technique integration point, DESIGN.md §5).  Port of
``repro.models.telemetry``.

``collect_moe_routing`` runs a MoE forward pass and returns the Boolean
routing relation — for every routed (token, expert, layer) slot one
triple.  That relation IS a triadic formal context: feeding it to the
OAC pipeline (``core.BatchMiner``) yields triclusters of co-activated
(token-group × expert-group × layer-group), the expert-specialisation
patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.context import PolyadicContext
from . import common
from .lm import _as_index, compute_dtype
from .params import layer_slice


def routing_layer(cfg: ModelConfig, p, x: torch.Tensor,
                  positions: torch.Tensor):
    """One MoE layer of the routing pass: x (B,S,D) -> (x after the
    layer, router logits (B,S,E) in fp32, routes (B,S,k) int32)."""
    h = common.rmsnorm(x, p["attn_norm"], cfg.norm_eps, cfg.use_pallas)
    x = x + common.attention(cfg, p["attn"], h, positions,
                             impl=cfg.attn_impl, q_block=cfg.q_block)
    h = common.rmsnorm(x, p["mlp_norm"], cfg.norm_eps, cfg.use_pallas)
    logits = torch.einsum("bsd,de->bse", h,
                          p["moe"]["router"].to(h.dtype)).to(torch.float32)
    _, top_e = common.top_k(logits, cfg.top_k)
    y, _ = common.moe_ffn(cfg, p["moe"], h)
    return x + y, logits, top_e.to(torch.int32)


@torch.no_grad()
def collect_moe_routing(cfg: ModelConfig, params, tokens) -> np.ndarray:
    """tokens (B,S) int -> routes (L, B, S, k) int32 expert ids.  Runs on
    the parameters' device; ``cfg.attn_impl="pallas"`` takes the CUDA
    flash-attention kernel there."""
    if not cfg.is_moe:
        raise ValueError("routing telemetry needs a MoE config "
                         "(DESIGN.md §5 Arch-applicability)")
    dev = params["embed"].device
    x = params["embed"].to(compute_dtype(cfg))[_as_index(tokens, dev)]
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=dev)
    lp = params["layers"]
    routes = []
    for i in range(cfg.n_layers):
        x, _, top_e = routing_layer(cfg, layer_slice(lp, i), x, positions)
        routes.append(top_e)
    return torch.stack(routes).cpu().numpy()          # (L,B,S,k)


def routing_context(cfg: ModelConfig, tokens, routes) -> PolyadicContext:
    """(vocab-token, expert, layer) triples from collected routes, each
    once, in lexicographic order (the JAX package's
    ``np.unique(triples, axis=0)``, taken on one int64 key per triple)."""
    l, b, s, k = routes.shape
    e = int(cfg.n_experts)
    tok = np.broadcast_to(np.asarray(tokens, np.int64)[None, :, :, None],
                          routes.shape)
    lay = np.arange(l, dtype=np.int64)[:, None, None, None]
    key = np.unique(((tok * e + routes) * l + lay).reshape(-1))
    triples = np.stack([key // (e * l), key // l % e, key % l], axis=1)
    return PolyadicContext((int(cfg.vocab_size), e, l), triples)
