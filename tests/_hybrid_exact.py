"""The hybrid family's (Zamba2) logits evaluated in float64 with numpy,
independently of both packages: the reference that the float32 parity of
``tests/test_torch_hybrid.py`` and ``scripts/hybrid_float32_witness.py``
measure both packages against.

Each Mamba2 layer runs as its recurrence, one position at a time,
``h_t = exp(dt_t a) h_{t-1} + dt_t x_t (x) B_t``, ``y_t = h_t C_t + D x_t``
(no chunks, so no clip of the log-decays and no chunk-state scan); the
shared block's attention materialises its causal scores.  The weights are
read as they are (JAX arrays, numpy arrays or CPU tensors) and widened to
float64 one matrix at a time, so a full-width model costs its float32
weights and one layer's float64 copies.
"""
from __future__ import annotations

import numpy as np


def _f64(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _norm(x, scale, eps):
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + eps) * _f64(scale)


def _silu(x):
    return x / (1.0 + np.exp(-x))


def _at(tree: dict, *index) -> dict:
    """The leaves of one stacked layer."""
    return {k: v[index] for k, v in tree.items()}


def _mamba(cfg, p: dict, x: np.ndarray) -> np.ndarray:
    b, s, _ = x.shape
    di, n, hp, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_heads
    u = _norm(x, p["norm"], cfg.norm_eps)
    z = u @ _f64(p["wz"])
    conv_in = np.concatenate([u @ _f64(p["wx"]), u @ _f64(p["wB"]),
                              u @ _f64(p["wC"])], -1)
    dt_raw = u @ _f64(p["wdt"])
    w = _f64(p["conv_w"])
    width = w.shape[0]
    padded = np.concatenate(
        [np.zeros((b, width - 1, conv_in.shape[2])), conv_in], 1)
    conv = sum(padded[:, i:i + s] * w[i] for i in range(width))
    conv = _silu(conv + _f64(p["conv_b"]))
    xs, bm, cm = conv[..., :di], conv[..., di:di + n], conv[..., di + n:]
    dt = np.logaddexp(0.0, dt_raw + _f64(p["dt_bias"]))        # softplus
    a = -np.exp(_f64(p["A_log"]))
    xh = xs.reshape(b, s, h, hp)
    state = np.zeros((b, h, hp, n))
    y = np.empty((b, s, h, hp))
    for t in range(s):
        state = (state * np.exp(dt[:, t] * a)[..., None, None]
                 + (dt[:, t, :, None] * xh[:, t])[..., None]
                 * bm[:, t, None, None, :])
        y[:, t] = np.einsum("bhpn,bn->bhp", state, cm[:, t])
    y = y + _f64(p["D_skip"])[:, None] * xh
    g = y.reshape(b, s, di) * _silu(z)
    return x + _norm(g, p["norm_scale"], cfg.norm_eps) @ _f64(p["out_proj"])


def _rope(x, positions, theta):
    half = x.shape[-1] // 2
    freqs = theta ** (-np.arange(half, dtype=np.float64) / half)
    ang = positions.astype(np.float64)[:, None] * freqs
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return np.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], -1)


def _shared(cfg, p: dict, x: np.ndarray) -> np.ndarray:
    b, s, _ = x.shape
    at = p["attn"]
    u = _norm(x, p["attn_norm"], cfg.norm_eps)
    q, k, v = (np.einsum("bsd,dhk->bshk", u, _f64(at[w]))
               for w in ("wq", "wk", "wv"))
    pos = np.arange(s)
    q, k = _rope(q, pos, cfg.rope_theta), _rope(k, pos, cfg.rope_theta)
    group = cfg.n_heads // cfg.n_kv_heads
    k, v = np.repeat(k, group, 2), np.repeat(v, group, 2)
    sc = np.einsum("bqhk,bthk->bhqt", q, k) * cfg.head_dim ** -0.5
    sc = np.where(np.tril(np.ones((s, s), bool)), sc, -np.inf)
    sc = np.exp(sc - sc.max(-1, keepdims=True))
    sc = sc / sc.sum(-1, keepdims=True)
    o = np.einsum("bhqt,bthk->bqhk", sc, v).reshape(b, s, -1)
    x = x + o @ _f64(at["wo"])
    m = p["mlp"]
    u = _norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + (_silu(u @ _f64(m["w_gate"])) * (u @ _f64(m["w_up"]))
                ) @ _f64(m["w_down"])


def logits(cfg, params: dict, tokens) -> np.ndarray:
    """Logits (B, S, V) in float64 of ``tokens`` (B, S) from position 0:
    groups of ``attn_every`` Mamba2 layers each ending with the shared
    block, then the tail layers, ``out_norm`` and ``lm_head``."""
    assert cfg.family == "hybrid_ssm" and not cfg.qk_norm
    assert cfg.window is None and not cfg.tie_embeddings
    x = _f64(params["embed"])[np.asarray(tokens)]
    layers = params["layers"]
    main = layers["mamba_main"]
    ng, period = main["norm"].shape[:2]
    for g in range(ng):
        for i in range(period):
            x = _mamba(cfg, _at(main, g, i), x)
        x = _shared(cfg, params["shared"], x)
    tail = layers.get("mamba_tail")
    for i in range(0 if tail is None else tail["norm"].shape[0]):
        x = _mamba(cfg, _at(tail, i), x)
    return _norm(x, params["out_norm"], cfg.norm_eps) @ _f64(
        params["lm_head"])
