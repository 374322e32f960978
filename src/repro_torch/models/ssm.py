"""Mamba2 (SSD) layer: chunked matmul path for full sequences, recurrent
decode.  Port of ``repro.models.ssm``.

Shapes: x (B,S,D) -> (B,S,D); heads H = d_inner / ssm_head_dim, state
dim N.  The casts are the JAX package's: the five input projections and
the output projection run in x's dtype, the SSD math in float32
(``common.wide``: float64 for float64 inputs), every
``exp`` of a log-decay is clipped to ``[_LOG_MIN, 0]`` first and the
causal ``tri`` mask multiplies the scores.  The JAX package runs the
inter-chunk recurrence ``h_c = d_c·h_{c-1} + S_c`` as a
``jax.lax.associative_scan`` over the chunk states; here it is a loop
over the ``S / chunk`` chunks (8 at S = 2,048 and chunk 256) carrying the
inclusive states, the same recurrence summed in another order.  A
sequence longer than ``ssm_chunk`` must be a whole number of chunks, as
the JAX function asserts.  The gated RMSNorm ``rmsnorm(y · silu(z))``
passes ``use_pallas=cfg.use_pallas`` (the ``rmsnorm`` kernel at width
d_inner).

Over a device mesh (``lay``, a ``models.layout.Layout`` whose ``ssm`` is
not ``None``) each rank holds its block of the ``ssm_inner`` columns
(``wz``, ``wx``, ``norm_scale``, the rows of ``out_proj``) and of the
``ssm_heads`` (``wdt``, ``dt_bias``, ``A_log``, ``D_skip``); ``wB``,
``wC``, ``conv_w`` and ``conv_b`` are whole.  It computes its heads'
SSD with the whole B and C, the conv over its ``xs`` columns and all of
B's and C's, the gated norm's sum of squares summed over the shards
before the scale (the kernel computes a row's statistics alone, so it is
not on that path), and ``out_proj`` row-parallel, then a ``psum``.  The
decode cache's conv window is split on its last axis (``d_inner + 2N``,
labelled ``ssm_inner``) in the JAX package's layout, which is not the
``xs`` split: the state handoff gathers the window's columns (3 rows of
them) and keeps this rank's block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.collectives import copy_to, reduce_from
from . import common

_LOG_MIN = -60.0


def _depthwise_causal_conv(x: torch.Tensor, w: torch.Tensor,
                           state: torch.Tensor = None):
    """x (B,S,C), w (W,C) depthwise causal conv, the taps summed in
    float32 in the order i = 0..W-1.  With ``state`` (B,W-1,C) (decode
    path, S == 1) returns (y, new_state)."""
    width = w.shape[0]
    f32 = common.wide(x.dtype)
    if state is not None:
        window = torch.cat([state, x], dim=1)                # (B,W,C)
        wf = window.to(f32)
        y = wf[:, 0] * w[0].to(f32)
        for i in range(1, width):
            y = y + wf[:, i] * w[i].to(f32)
        return y[:, None].to(x.dtype), window[:, 1:]
    s = x.shape[1]
    pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)
    y = xp[:, 0:s].to(f32) * w[0].to(f32)
    for i in range(1, width):
        y = y + xp[:, i:i + s].to(f32) * w[i].to(f32)
    return y.to(x.dtype), None


def _comm(lay):
    return None if lay is None else lay.ssm


def _shapes(cfg: ModelConfig, lay):
    """(d_inner, heads) of this rank's block."""
    c = _comm(lay)
    n = 1 if c is None else c.size
    return cfg.d_inner // n, cfg.ssm_heads // n


def _project(cfg: ModelConfig, p, x: torch.Tensor, lay):
    """The five input projections in x's dtype -> (z, xs, B, C, dt_raw);
    over a mesh z, xs and dt_raw are this rank's columns and heads."""
    c = _comm(lay)
    dt = x.dtype
    x = copy_to(c, x)
    wb, wc = p["wB"].to(dt), p["wC"].to(dt)
    if c is not None:          # whole weights used on this rank's heads
        wb, wc = copy_to(c, wb), copy_to(c, wc)
    z = torch.einsum("bsd,de->bse", x, p["wz"].to(dt))
    xs = torch.einsum("bsd,de->bse", x, p["wx"].to(dt))
    bmat = torch.einsum("bsd,dn->bsn", x, wb)
    cmat = torch.einsum("bsd,dn->bsn", x, wc)
    dt_raw = torch.einsum("bsd,dh->bsh", x, p["wdt"].to(dt))
    return z, xs, bmat, cmat, dt_raw


def _conv_weights(cfg: ModelConfig, p, lay):
    """(conv_w, conv_b) over this rank's conv columns: its ``xs`` block,
    then all of B's and C's."""
    w, b = p["conv_w"], p["conv_b"]
    c = _comm(lay)
    if c is None:
        return w, b
    w, b = copy_to(c, w), copy_to(c, b)
    di = cfg.d_inner
    dl = di // c.size
    lo = c.index() * dl
    return (torch.cat([w[:, lo:lo + dl], w[:, di:]], dim=1),
            torch.cat([b[lo:lo + dl], b[di:]], dim=0))


def _gated_norm(cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
                scale: torch.Tensor, lay) -> torch.Tensor:
    """rmsnorm(y · silu(z), scale) over d_inner; over a mesh the sum of
    squares of every shard's columns (``psum``, whose cotangent is summed
    too: each shard scales its own columns by it)."""
    g = y * F.silu(z)
    c = _comm(lay)
    if c is None:
        return common.rmsnorm(g, scale, cfg.norm_eps, cfg.use_pallas)
    gf = g.to(common.wide(g.dtype))
    ss = reduce_from(c, copy_to(c, torch.sum(gf * gf, dim=-1, keepdim=True)))
    var = ss / cfg.d_inner
    return (gf * torch.rsqrt(var + cfg.norm_eps)
            * scale.to(gf.dtype)).to(g.dtype)


def _out_proj(y: torch.Tensor, w: torch.Tensor, lay) -> torch.Tensor:
    return reduce_from(_comm(lay), torch.einsum("bse,ed->bsd", y,
                                                w.to(y.dtype)))


def _whole_conv_in(cfg: ModelConfig, xs, bmat, cmat, lay) -> torch.Tensor:
    """[xs | B | C] over every column of d_inner + 2N (the conv window's
    layout): this rank's ``xs`` gathered over the shards."""
    c = _comm(lay)
    if c is not None:
        xs = c.all_gather(xs.contiguous(), -1)
    return torch.cat([xs, bmat, cmat], dim=-1)


def _conv_block(lay, window: torch.Tensor) -> torch.Tensor:
    """This rank's block of the conv window's columns (the cache layout),
    the whole window without a mesh or where the columns do not divide."""
    c = None if lay is None else lay.conv
    return window if c is None else c.local(window, -1).contiguous()


def check_length(cfg: ModelConfig, s: int) -> int:
    """The chunk of a sequence of ``s`` positions; raises where the JAX
    function's ``assert s % chunk == 0`` fails."""
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        raise ValueError(f"{cfg.name}: a sequence of {s} positions is longer "
                         f"than ssm_chunk={cfg.ssm_chunk} and not a multiple "
                         "of it (the chunked SSD takes whole chunks)")
    return chunk


def ssd_forward(cfg: ModelConfig, p, x: torch.Tensor,
                return_state: bool = False, lay=None):
    """Training / prefill forward of one Mamba2 layer (chunked SSD).

    With ``return_state`` also returns (ssm_state (B,H,hp,N) float32,
    conv_state (B,W-1,di+2N) in x's dtype) after the last position — the
    prefill handoff; over a mesh this rank's heads and its block of the
    conv window's columns."""
    b, s, _ = x.shape
    di, n, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    dl, h = _shapes(cfg, lay)
    chunk = check_length(cfg, s)
    nc = s // chunk
    f32 = common.wide(x.dtype)

    z, xs, bmat, cmat, dt_raw = _project(cfg, p, x, lay)
    conv_w, conv_b = _conv_weights(cfg, p, lay)
    conv_in = torch.cat([xs, bmat, cmat], dim=-1)
    conv_out, _ = _depthwise_causal_conv(conv_in, conv_w)
    conv_out = F.silu(conv_out + conv_b.to(conv_out.dtype))
    xs, bmat, cmat = torch.split(conv_out, [dl, n, n], dim=-1)

    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))    # (B,S,H)
    a = -torch.exp(p["A_log"].to(f32))                        # (H,)
    la = dt * a                                               # log-decay <= 0

    xh = xs.reshape(b, s, h, hp).to(f32)
    xbar = xh * dt[..., None]
    bm = bmat.to(f32).reshape(b, nc, chunk, n)
    cm = cmat.to(f32).reshape(b, nc, chunk, n)
    lac = la.reshape(b, nc, chunk, h)
    xbc = xbar.reshape(b, nc, chunk, h, hp)

    cum = torch.cumsum(lac, dim=2)                            # (B,nc,L,H)
    # intra-chunk: scores[b,c,i,j,h] = (C_i·B_j)·exp(cum_i − cum_j), j <= i
    cb = torch.einsum("bcin,bcjn->bcij", cm, bm)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,i,j,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    decay = torch.exp(torch.clamp(diff, _LOG_MIN, 0.0))
    del diff
    scores = cb[..., None] * decay * tri[None, None, :, :, None]
    del decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xbc)
    del scores

    # chunk states S_c[b,c,h,n,p] = Σ_j exp(cum_L − cum_j)·B_j ⊗ xbar_j
    tail = torch.exp(torch.clamp(cum[:, :, -1:, :] - cum, _LOG_MIN, 0.0))
    st = torch.einsum("bcjh,bcjn,bcjhp->bchnp", tail, bm, xbc)
    dchunk = torch.exp(torch.clamp(cum[:, :, -1, :], _LOG_MIN, 0.0))

    # inter-chunk recurrence h_c = d_c·h_{c-1} + S_c: the inclusive states
    sacc = [st[:, 0]]
    for ci in range(1, nc):
        sacc.append(st[:, ci] + dchunk[:, ci, :, None, None] * sacc[-1])
    # the state entering chunk c is sacc[c-1]
    h_prev = torch.stack([torch.zeros_like(sacc[0])] + sacc[:-1], dim=1)
    y_inter = torch.einsum("bcin,bchnp,bcih->bcihp", cm, h_prev,
                           torch.exp(torch.clamp(cum, _LOG_MIN, 0.0)))

    y = (y_intra + y_inter).reshape(b, s, h, hp)
    y = y + p["D_skip"].to(f32)[None, None, :, None] * xh
    y = y.reshape(b, s, dl).to(x.dtype)
    y = _gated_norm(cfg, y, z, p["norm_scale"], lay)
    out = _out_proj(y, p["out_proj"], lay)
    if return_state:
        # the last inclusive chunk state in the decode layout (B,H,hp,N)
        final = sacc[-1].transpose(2, 3).contiguous()
        tail_in = conv_in[:, s - (cfg.conv_width - 1):]
        if lay is not None and lay.ssm is not None:
            tail_in = _whole_conv_in(cfg, tail_in[..., :dl],
                                     tail_in[..., dl:dl + n],
                                     tail_in[..., dl + n:], lay)
        return out, final, _conv_block(lay, tail_in).to(x.dtype)
    return out


def ssd_decode(cfg: ModelConfig, p, x: torch.Tensor,
               ssm_state: torch.Tensor, conv_state: torch.Tensor, lay=None):
    """One-token recurrent step. x (B,1,D); ssm_state (B,H,hp,N);
    conv_state (B,W-1,di+2N).  Returns (y, ssm_state', conv_state'), new
    tensors.  Over a mesh the states are this rank's blocks (its heads;
    its block of the conv window's columns)."""
    b = x.shape[0]
    di, n, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    dl, h = _shapes(cfg, lay)
    f32 = common.wide(x.dtype)

    z, xs, bmat, cmat, dt_raw = _project(cfg, p, x, lay)
    c = _comm(lay)
    if c is None:
        conv_in = torch.cat([xs, bmat, cmat], dim=-1)
        conv_out, conv_state = _depthwise_causal_conv(conv_in, p["conv_w"],
                                                      conv_state)
        conv_b = p["conv_b"]
    else:
        # the whole window: the cache's blocks and the new column
        cv = lay.conv
        whole = conv_state if cv is None else cv.all_gather(
            conv_state.contiguous(), -1)
        conv_in = _whole_conv_in(cfg, xs, bmat, cmat, lay)
        conv_out, window = _depthwise_causal_conv(conv_in, p["conv_w"],
                                                  whole)
        conv_state = _conv_block(lay, window)
        lo = c.index() * dl
        conv_out = torch.cat([conv_out[..., lo:lo + dl],
                              conv_out[..., di:]], dim=-1)
        conv_b = torch.cat([p["conv_b"][lo:lo + dl], p["conv_b"][di:]])
    conv_out = F.silu(conv_out + conv_b.to(conv_out.dtype))
    xs, bmat, cmat = torch.split(conv_out[:, 0], [dl, n, n], dim=-1)

    dt = F.softplus(dt_raw[:, 0].to(f32) + p["dt_bias"].to(f32))   # (B,H)
    a = -torch.exp(p["A_log"].to(f32))
    decay = torch.exp(dt * a)                                      # (B,H)

    xh = xs.reshape(b, h, hp).to(f32)
    xbar = xh * dt[..., None]
    upd = torch.einsum("bhp,bn->bhpn", xbar, bmat.to(f32))
    ssm_state = ssm_state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", ssm_state, cmat.to(f32))
    y = y + p["D_skip"].to(f32)[None, :, None] * xh
    y = y.reshape(b, 1, dl).to(x.dtype)
    y = _gated_norm(cfg, y, z, p["norm_scale"], lay)
    out = _out_proj(y, p["out_proj"], lay)
    return out, ssm_state, conv_state
