"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).  Port
of ``repro.models.xlstm``.

The mLSTM runs its stabilised parallel form for full sequences: one
S x S decay-masked pass (``_mlstm_chunk`` over the whole sequence) when
``s <= ssm_chunk`` or ``s`` is not a multiple of it, else the chunkwise
form, a loop over the ``s / ssm_chunk`` chunks carrying (C, n, m) where
the JAX package has a ``lax.scan``.  Both forms compute the same numbers
up to rounding and neither refuses a length.  The sLSTM is a loop over
time (the JAX package's ``lax.scan``) of ``_slstm_step``; its hidden
state ``hs`` is carried in the compute dtype, rounded every step, as the
JAX carry is.  Decode is one recurrent step of each.

The casts are the JAX package's: projections in x's dtype, the cell
arithmetic in float32 (``common.wide``: float64 for float64 inputs), the
mLSTM's key scaled after its cast (a bfloat16 array divided by a numpy
float64 promotes to float32 in JAX), ``jax.nn.gelu``'s tanh
approximation.  The stabilisers ``m`` start at -1e30.  The headwise norm
of the mLSTM (a scale per head's columns) is plain PyTorch, as it is
plain jnp in JAX; the sLSTM's norm of ``hs`` passes
``use_pallas=cfg.use_pallas`` (the ``rmsnorm`` kernel).

Over a device mesh (``lay``, a ``models.layout.Layout`` whose ``ff`` is
not ``None``) each rank holds its block of the mLSTM's ``ff`` columns
(``w_up``, ``wq``/``wk``/``wv``, ``norm_scale``, the rows of ``w_down``)
and of its ``heads`` (``wi``, ``wf``, the cache's C, n, m), which are the
same heads.  ``w_up``'s column block is not a block of both halves
(u, z), so the projection is all-gathered before the split: every rank
takes all of u and its heads' columns of z; ``w_down`` is row-parallel,
then a ``psum``.  Where the heads do not divide the ``ff`` axes
(``lay.heads`` ``None``: ``wi``, ``wf`` and the cache whole) every rank
gathers its columns of q, k and v, runs every head, and keeps its
columns of the normalised output for ``w_down``; the gates sum their
rows of ``wi``/``wf`` over the ranks (``psum``), so every cotangent of u
stays a partial sum over the column blocks, and the rows' gradients are
summed into the replicated weights'.  The sLSTM runs whole on every
rank: ``r_gates`` (sharded over its heads, ``lay.rec``) is gathered once
a call, so no collective runs inside the loop over time, and the cache
keeps this rank's heads of c, n, m (gathered at each decode step).  Its
gated MLP is column-parallel over ``lay.mlp_up`` (gathered before the
split) and row-parallel over ``lay.mlp_down`` where ``w_mlp_down``'s
rows divide, else whole.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.collectives import copy_to, gather_from, reduce_from
from . import common

_NEG = -1e30


def _headwise_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                      eps: float, cols=None) -> torch.Tensor:
    """x (B,S,H,P); normalise per head (GroupNorm analogue) -> (B,S,H·P)
    in x's dtype; ``cols`` (collectives): this shard's block of the
    columns, which ``scale`` is."""
    f32 = common.wide(x.dtype)
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).reshape(*x.shape[:-2], -1)
    return (_local(cols, y) * scale.to(f32)).to(x.dtype)


def _ff(lay):
    return None if lay is None else lay.ff


def _whole_heads(lay):
    """The ``ff`` collectives where every rank runs every mLSTM head (the
    heads do not divide the ``ff`` axes), else ``None``."""
    return None if lay is None or lay.heads is not None else lay.ff


def _halves(x: torch.Tensor, w: torch.Tensor, comm, partial: bool):
    """x @ w (D, 2E) split in its two halves (B,S,E), each whole.  Over
    ``comm`` (``w``'s column block) the product is all-gathered first;
    ``partial``: the halves' cotangents are partial sums over the shards
    (summed in the backward), else every rank's is whole."""
    x = copy_to(comm, x)
    up = torch.einsum("bsd,de->bse", x, w.to(x.dtype))
    if comm is not None:
        up = gather_from(comm, up, -1, comm if partial else None)
    return torch.chunk(up, 2, dim=-1)


def _local(comm, t: torch.Tensor) -> torch.Tensor:
    return t if comm is None else comm.local(t, -1)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_chunk(q, k, v, i_raw, logf, state, want_state: bool = True):
    """One chunk of the chunkwise-parallel stabilised mLSTM.

    q/k/v (B,L,H,P); i_raw/logf (B,L,H); state = (C (B,H,P,P), n (B,H,P),
    m (B,H)).  Returns (h (B,L,H,P), new_state); composes the per-step
    recurrence of :func:`mlstm_decode` over L steps.  Without
    ``want_state`` the state update is not computed (``None``): the last
    chunk of a forward that returns no state, whose update nothing reads
    (the JAX package's XLA drops it as dead code)."""
    cum = torch.cumsum(logf, dim=1)                       # (B,L,H)
    total = cum[:, -1]                                    # (B,H)
    c_prev, n_prev, m_prev = state
    l = q.shape[1]
    # intra-chunk decay matrix
    logd = (cum[:, :, None, :] - cum[:, None, :, :]
            + i_raw[:, None, :, :])                       # (B,i,j,H)
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    logd = logd.masked_fill(~tri[None, :, :, None], _NEG)
    m_intra = logd.amax(dim=2)                            # (B,L,H)
    m_inter = cum + m_prev[:, None, :]                    # decay from start
    m_t = torch.maximum(m_intra, m_inter)
    dmat = torch.exp(logd - m_t[:, :, None, :])
    del logd
    scores = torch.einsum("bihp,bjhp->bijh", q, k) * dmat
    del dmat
    inter_w = torch.exp(m_inter - m_t)                    # (B,L,H)
    qc = torch.einsum("bihp,bhpq->bihq", q, c_prev)
    num = (torch.einsum("bijh,bjhp->bihp", scores, v)
           + inter_w[..., None] * qc)
    qn = torch.einsum("bihp,bhp->bih", q, n_prev)
    den = torch.maximum(torch.abs(scores.sum(dim=2) + inter_w * qn),
                        torch.exp(-m_t))
    hv = num / den[..., None]
    if not want_state:
        return hv, None
    # state update (decay everything to the chunk end)
    logw = total[:, None, :] - cum + i_raw                # (B,L,H)
    m_w = logw.amax(dim=1)                                # (B,H)
    m_new = torch.maximum(total + m_prev, m_w)
    carry_w = torch.exp(total + m_prev - m_new)
    wgt = torch.exp(logw - m_new[:, None, :])
    c_new = (carry_w[..., None, None] * c_prev
             + torch.einsum("bjh,bjhp,bjhq->bhpq", wgt, k, v))
    n_new = (carry_w[..., None] * n_prev
             + torch.einsum("bjh,bjhp->bhp", wgt, k))
    return hv, (c_new, n_new, m_new)


def _mlstm_inputs(cfg: ModelConfig, p, x: torch.Tensor, lay):
    """The mLSTM's projections of x (B,S,D) -> (q, k, v (B,S,Hl,P) and
    i_raw, log f (B,S,Hl) in float32; z (B,S,Hl·P) in x's dtype) for this
    rank's heads (all of them without a mesh)."""
    b, s, d = x.shape
    dm = int(d * cfg.mlstm_proj)
    hp = dm // cfg.n_heads
    f32 = common.wide(x.dtype)
    c = _ff(lay)
    whole = _whole_heads(lay)
    u, z = _halves(x, p["w_up"], c, partial=True)         # (B,S,dm) each
    z = _local(c, z)
    dt = x.dtype
    q = torch.einsum("bse,ef->bsf", u, p["wq"].to(dt))
    k = torch.einsum("bse,ef->bsf", u, p["wk"].to(dt))
    v = torch.einsum("bse,ef->bsf", u, p["wv"].to(dt))
    if whole is not None:
        q, k, v = (gather_from(whole, t, -1) for t in (q, k, v))
    k = k.to(f32) / math.sqrt(hp)
    hl = q.shape[-1] // hp
    q = q.reshape(b, s, hl, hp).to(f32)
    k = k.reshape(b, s, hl, hp)
    v = v.reshape(b, s, hl, hp).to(f32)

    def gate(w):
        if whole is None:
            return torch.einsum("bse,eh->bsh", u, w.to(dt)).to(f32)
        # each rank's rows of the whole weight: its gradient is summed
        # over the ranks (``copy_to``), as it is replicated
        return reduce_from(whole, torch.einsum(
            "bse,eh->bsh", _local(whole, u),
            whole.local(copy_to(whole, w), 0).to(dt))).to(f32)
    return q, k, v, gate(p["wi"]), F.logsigmoid(gate(p["wf"])), z


def _mlstm_out(cfg: ModelConfig, p, hv: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype, lay) -> torch.Tensor:
    """headwise norm, the gate silu(z), ``w_down`` (row-parallel over
    ``lay.ff``, then ``psum``)."""
    whole = _whole_heads(lay)
    if whole is not None:        # every head here, this rank's columns out
        hv = copy_to(whole, hv)
    hv = _headwise_rmsnorm(hv, p["norm_scale"], cfg.norm_eps, whole)
    out = hv.to(dtype) * F.silu(z)
    return reduce_from(_ff(lay), torch.einsum("bse,ed->bsd", out,
                                              p["w_down"].to(dtype)))


def mlstm_forward(cfg: ModelConfig, p, x: torch.Tensor,
                  return_state: bool = False, lay=None):
    """Parallel (training / prefill) mLSTM block. x (B,S,D) -> (B,S,D).
    With ``return_state`` also (C (B,H,P,P), n (B,H,P), m (B,H)) after
    the last position, float32 (this rank's heads over a mesh).

    Sequences longer than ``cfg.ssm_chunk`` and a whole number of chunks
    run the chunkwise form (peak decay matrix (B,L,L,H) instead of
    (B,S,S,H)); any other length the one-shot S x S form."""
    b, s, _ = x.shape
    q, k, v, i_raw, logf, z = _mlstm_inputs(cfg, p, x, lay)
    hl, hp = q.shape[2], q.shape[3]
    f32 = q.dtype
    chunk = cfg.ssm_chunk or 256
    state = (torch.zeros((b, hl, hp, hp), dtype=f32, device=x.device),
             torch.zeros((b, hl, hp), dtype=f32, device=x.device),
             torch.full((b, hl), _NEG, dtype=f32, device=x.device))
    if s > chunk and s % chunk == 0:
        parts = []
        for lo in range(0, s, chunk):
            ch = slice(lo, lo + chunk)
            hv_c, state = _mlstm_chunk(
                q[:, ch], k[:, ch], v[:, ch], i_raw[:, ch], logf[:, ch],
                state, return_state or lo + chunk < s)
            parts.append(hv_c)
        hv = torch.cat(parts, dim=1)
    else:
        hv, state = _mlstm_chunk(q, k, v, i_raw, logf, state, return_state)
    y = _mlstm_out(cfg, p, hv, z, x.dtype, lay)
    if return_state:
        return (y,) + tuple(state)
    return y


def mlstm_decode(cfg: ModelConfig, p, x: torch.Tensor,
                 c_state: torch.Tensor, n_state: torch.Tensor,
                 m_state: torch.Tensor, lay=None):
    """Recurrent step. x (B,1,D); c (B,H,P,P); n (B,H,P); m (B,H) (this
    rank's heads over a mesh).  Returns (y, c', n', m'), new tensors."""
    q, k, v, i_raw, logf, z = _mlstm_inputs(cfg, p, x, lay)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                   # (B,Hl,P)
    i_raw, logf = i_raw[:, 0], logf[:, 0]                 # (B,Hl)
    m_new = torch.maximum(logf + m_state, i_raw)
    alpha = torch.exp(logf + m_state - m_new)
    beta = torch.exp(i_raw - m_new)
    c_state = (c_state * alpha[..., None, None]
               + beta[..., None, None] * k[..., :, None] * v[..., None, :])
    n_state = n_state * alpha[..., None] + beta[..., None] * k
    num = torch.einsum("bhp,bhpq->bhq", q, c_state)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", q, n_state)),
                        torch.exp(-m_new))
    hv = (num / den[..., None])[:, None]                  # (B,1,Hl,P)
    return _mlstm_out(cfg, p, hv, z, x.dtype, lay), c_state, n_state, m_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_consts(cfg: ModelConfig, p, dtype: torch.dtype, lay):
    """What every step reads: ``r_gates`` (whole: gathered over
    ``lay.rec``) in the carry's dtype, laid out (H, P, 4·P) for one
    batched product a step, and the float32 biases by head."""
    h, hp = cfg.n_heads, cfg.d_model // cfg.n_heads
    f32 = common.wide(dtype)
    r = p["r_gates"]
    rec = None if lay is None else lay.rec
    if rec is not None:
        r = gather_from(rec, r, 1)
    r = r.to(dtype).permute(1, 2, 0, 3).reshape(h, hp, 4 * hp)
    return (r, p["b_i"].to(f32).reshape(h, hp),
            p["b_f"].to(f32).reshape(h, hp))


def _slstm_step(cfg: ModelConfig, consts, carry, gx):
    """One recurrence step. carry = (c, n (B,H,P) float32, hs (B,D) in
    the compute dtype, m (B,H) float32); gx = the input projections
    (B,4,H,P) in float32."""
    r, b_i, b_f = consts
    c, n, hs, m = carry
    b = c.shape[0]
    h, hp = cfg.n_heads, cfg.d_model // cfg.n_heads
    f32 = gx.dtype
    # rec[b, g, h, q] = Σ_p hs[b, h, p] · r_gates[g, h, p, q], per head
    rec = torch.bmm(hs.reshape(b, h, hp).transpose(0, 1), r)
    rec = rec.reshape(h, b, 4, hp).permute(1, 2, 0, 3)      # (B,4,H,P)
    g = gx + rec.to(f32)
    i_raw, f_raw, z_raw, o_raw = g.unbind(1)
    i_raw = i_raw + b_i
    f_raw = f_raw + b_f
    lf_m = F.logsigmoid(f_raw) + m[..., None]
    m_new = torch.maximum(lf_m, i_raw).amax(-1)             # (B,H) shared
    alpha = torch.exp(lf_m - m_new[..., None])
    beta = torch.exp(i_raw - m_new[..., None])
    c = alpha * c + beta * torch.tanh(z_raw)
    n = alpha * n + beta
    hv = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1e-6)
    hs_new = hv.reshape(b, -1).to(hs.dtype)
    return (c, n, hs_new, m_new), hs_new


def _gates_in(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The sLSTM's input projections of x (B,S,D), in x's dtype, cast to
    float32 once for every step -> (B,S,4,H,P)."""
    b, s, d = x.shape
    gx = torch.einsum("bsd,dge->bsge", x,
                      p["w_gates"].to(x.dtype).reshape(d, 4, d))
    return gx.to(common.wide(x.dtype)).reshape(
        b, s, 4, cfg.n_heads, d // cfg.n_heads)


def _slstm_mlp(cfg: ModelConfig, p, hs: torch.Tensor,
               dtype: torch.dtype, lay) -> torch.Tensor:
    """The sLSTM's norm of hs, then its gated MLP (projection factor
    ``slstm_proj``, gelu's tanh form)."""
    hs = common.rmsnorm(hs, p["norm_scale"], cfg.norm_eps, cfg.use_pallas)
    cu = None if lay is None else lay.mlp_up
    cd = None if lay is None else lay.mlp_down
    g, u = _halves(hs.to(dtype), p["w_mlp_up"], cu, partial=cd is not None)
    act = _local(cd, F.gelu(g, approximate="tanh") * u)
    return reduce_from(cd, torch.einsum("bse,ed->bsd", act,
                                        p["w_mlp_down"].to(dtype)))


def _heads_block(lay, state):
    """This rank's heads of a whole sLSTM state (c, n, hs, m)."""
    rec = None if lay is None else lay.rec
    if rec is None:
        return state
    c, n, hs, m = state
    return rec.local(c, 1), rec.local(n, 1), hs, rec.local(m, 1)


def slstm_forward(cfg: ModelConfig, p, x: torch.Tensor,
                  return_state: bool = False, lay=None):
    """sLSTM block (sequential over S). x (B,S,D) -> (B,S,D).  With
    ``return_state`` also the state (c, n, hs, m) after the last
    position (this rank's heads of c, n and m over a mesh)."""
    b, s, d = x.shape
    h, hp = cfg.n_heads, d // cfg.n_heads
    f32 = common.wide(x.dtype)
    gx = _gates_in(cfg, p, x)                             # (B,S,4,H,P)
    consts = _slstm_consts(cfg, p, x.dtype, lay)
    carry = (torch.zeros((b, h, hp), dtype=f32, device=x.device),
             torch.zeros((b, h, hp), dtype=f32, device=x.device),
             torch.zeros((b, d), dtype=x.dtype, device=x.device),
             torch.full((b, h), _NEG, dtype=f32, device=x.device))
    out = []
    for t in range(s):
        carry, hs_t = _slstm_step(cfg, consts, carry, gx[:, t])
        out.append(hs_t)
    y = _slstm_mlp(cfg, p, torch.stack(out, dim=1), x.dtype, lay)
    if return_state:
        return y, _heads_block(lay, carry)
    return y


def slstm_decode(cfg: ModelConfig, p, x: torch.Tensor, state, lay=None):
    """One-token step; state = (c, n, hs, m) (this rank's heads of c, n
    and m over a mesh, gathered for the step).  Returns (y, state')."""
    rec = None if lay is None else lay.rec
    if rec is not None:
        c, n, hs, m = state
        state = (rec.all_gather(c, 1), rec.all_gather(n, 1), hs,
                 rec.all_gather(m, 1))
    consts = _slstm_consts(cfg, p, x.dtype, lay)
    state, hs = _slstm_step(cfg, consts, state, _gates_in(cfg, p, x)[:, 0])
    y = _slstm_mlp(cfg, p, hs[:, None], x.dtype, lay)
    return y, _heads_block(lay, state)
