"""Shared model primitives: norms, RoPE, attention (train/prefill/decode),
SwiGLU MLP, and the capacity-dispatch MoE layer.  Port of
``repro.models.common``.

All functions but ``attention_decode`` are pure; parameters are the
nested trees of ``params.init_params`` (``ParamTree``) or plain dicts of
tensors.  Each
function rounds where the JAX function rounds: an einsum in the working
dtype (bf16 on the model path) stays in it, and one with
``preferred_element_type=float32`` runs on fp32 copies of its operands,
whose products of bf16 values are exact.  The MoE dispatch is the same
fixed-capacity sort-and-route pattern as the triclustering shuffle engine
(DESIGN.md §3).

Two switches pick the hand-written kernels, as the JAX package's config
documents them: ``rmsnorm(use_pallas=True)`` runs ``kernels.ops.rmsnorm``
and ``attention_decode`` with ``cfg.attn_impl == "pallas"`` runs
``kernels.ops.decode_attention`` (each the CUDA kernel on CUDA tensors,
its plain version on CPU tensors).  ``attention_decode`` writes the ring
cache in place.

Over a device mesh every function takes a ``models.layout.Layout``
(``lay``) and this rank's blocks of the weights, and computes SPMD by
hand what GSPMD partitions in the JAX package: Megatron's tensor
parallelism (``core.collectives.copy_to`` in front of a column-parallel
projection and of each replicated weight used on the local heads,
``reduce_from`` after the row-parallel one), both MoE dispatch paths of
``moe_ffn`` (``cfg.moe_impl``), and split-KV decode over a ring whose
slots are sharded (``pmax`` of the maxima, ``psum`` of the sums and of
the values).  Where ``lay`` is ``None``, or every dimension it names is
whole on this rank, the code is the one-device code.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.collectives import copy_to, gather_from, reduce_from
from ..kernels import ops, ref

_NEG = -1e30


# ---------------------------------------------------------------------------
# Norms / RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            use_pallas: bool = False) -> torch.Tensor:
    if use_pallas:
        return ops.rmsnorm(x, scale, eps)
    return ref.rmsnorm_ref(x, scale, eps)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., head_dim/2) for integer positions.  The base
    goes to ``torch.pow`` as a Python number: the kernel reads it as a
    float32 argument, where a tensor on the card would be a blocking copy
    (a host sync per layer)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(float(theta), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd); cos/sin (..., S, hd/2) — llama half-rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[..., None, :], sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _qkv(cfg: ModelConfig, p, x: torch.Tensor, positions: torch.Tensor):
    """Project + (optional) per-head QK-norm + RoPE.
    x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps, cfg.use_pallas)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps, cfg.use_pallas)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    return q, k, v


def _qkv_local(cfg: ModelConfig, p, x: torch.Tensor,
               positions: torch.Tensor, lay=None):
    """``_qkv`` on this rank's heads: q (B,S,Hl,hd) of its query heads and
    k/v (B,S,KVh,hd) of its KV heads (all of them where ``wk`` is not
    sharded).  Returns (q, k, v)."""
    heads = None if lay is None else lay.heads
    if heads is None:
        return _qkv(cfg, p, x, positions)
    xf = copy_to(heads, x)
    q = torch.einsum("bsd,dhk->bshk", xf, p["wq"].to(x.dtype))
    wk, wv = p["wk"].to(x.dtype), p["wv"].to(x.dtype)
    if lay.kv is None:                    # replicated KV weights
        wk, wv = copy_to(heads, wk), copy_to(heads, wv)
    k = torch.einsum("bsd,dhk->bshk", xf, wk)
    v = torch.einsum("bsd,dhk->bshk", xf, wv)
    if cfg.qk_norm:
        q = rmsnorm(q, copy_to(heads, p["q_norm"]), cfg.norm_eps,
                    cfg.use_pallas)
        k = rmsnorm(k, copy_to(heads, p["k_norm"]), cfg.norm_eps,
                    cfg.use_pallas)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def kv_for_heads(cfg: ModelConfig, k: torch.Tensor, lay, whole: bool,
                 all_heads: bool = False):
    """KV heads (dim 2 of ``k``) for this rank's query heads -> (k', g):
    query head j reads KV head j // g of ``k'``.  ``whole``: ``k`` holds
    every KV head (else the block of ``lay.heads``' axes); ``all_heads``:
    the queries are every head, not this rank's."""
    group = cfg.n_heads // cfg.n_kv_heads
    heads = None if lay is None or all_heads else lay.heads
    if heads is None or not whole:
        return k, group
    hl = cfg.n_heads // heads.size
    first = heads.index() * hl
    if hl % group == 0:
        return k[:, :, first // group:(first + hl) // group], group
    idx = torch.div(torch.arange(first, first + hl, device=k.device),
                    group, rounding_mode="floor")
    return k.index_select(2, idx), 1


def out_proj(o: torch.Tensor, wo: torch.Tensor, d: int, lay=None,
             all_heads: bool = False):
    """o (B,S,Hl·hd) @ wo's rows -> (B,S,D): row-parallel over the heads'
    axes, then ``psum``; whole heads (``all_heads``, or heads that are not
    sharded) with sharded rows take their columns of o first."""
    w = wo.to(o.dtype).reshape(-1, d)
    c = None if lay is None else lay.wo
    if c is None:
        return torch.einsum("bse,ed->bsd", o, w)
    if lay.heads is None or all_heads:
        o = c.local(copy_to(c, o), -1)
    return reduce_from(c, torch.einsum("bse,ed->bsd", o, w))


def _mask(q_pos, k_pos, window: Optional[int]) -> torch.Tensor:
    """(..., Sq, Sk) causal/window mask from position arrays."""
    m = k_pos[..., None, :] <= q_pos[..., :, None]
    if window is not None:
        m &= k_pos[..., None, :] > q_pos[..., :, None] - window
    return m


def _sdpa(q, k, v, mask, scale: float) -> torch.Tensor:
    """q (B,Sq,H,hd), k/v (B,Sk,H,hd), mask (B or 1, Sq, Sk).
    Scores from fp32 copies of the operands (the JAX function's
    ``preferred_element_type=float32``), fp32 softmax, probabilities
    rounded to v's dtype before the second product."""
    f32 = torch.float32
    s = torch.einsum("bqhk,bthk->bhqt", q.to(f32), k.to(f32)) * scale
    s = torch.where(mask[:, None], s, torch.tensor(_NEG, dtype=f32,
                                                   device=s.device))
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bhqt,bthk->bqhk", a.to(v.dtype).to(f32),
                        v.to(f32)).to(q.dtype)


def blocked_sdpa(q, k, v, positions, window, scale: float,
                 q_block: int) -> torch.Tensor:
    """Tiled attention: one q block at a time, so the live scores are one
    (B,H,q_block,S) tile.  q/k/v are (B,S,H,hd) with H already
    GQA-expanded; a ragged tail block is the last, shorter tile."""
    s = q.shape[1]
    out = []
    for lo in range(0, s, q_block):
        qi = q[:, lo:lo + q_block]
        mask = _mask(positions[lo:lo + q_block][None], positions[None],
                     window)
        out.append(_sdpa(qi, k, v, mask, scale))
    return torch.cat(out, 1)


def attention(cfg: ModelConfig, p, x: torch.Tensor,
              positions: torch.Tensor, *, impl: str = "einsum",
              q_block: int = 2048, lay=None) -> torch.Tensor:
    """Full-sequence causal/SWA GQA attention (train / prefill).

    impl:
      einsum  — materialised (B,H,S,S) scores (baseline).
      blocked — q blocks one at a time, peak scores (B,H,q_block,S).
      pallas  — ``kernels.ops.flash_attention``: the CUDA kernel on CUDA
                tensors, its plain version on CPU tensors.

    Over a mesh (``lay``): this rank's query heads, their KV heads, then
    the row-parallel ``wo`` and a ``psum``."""
    b, s, d = x.shape
    q, k, v = _qkv_local(cfg, p, x, positions, lay)
    k, group = kv_for_heads(cfg, k, lay, lay is None or lay.kv is None)
    v, _ = kv_for_heads(cfg, v, lay, lay is None or lay.kv is None)
    scale = cfg.head_dim ** -0.5
    if impl == "pallas":
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=cfg.window, scale=scale)
        o = o.transpose(1, 2)
    else:
        k = torch.repeat_interleave(k, group, dim=2)   # GQA expand
        v = torch.repeat_interleave(v, group, dim=2)
        if impl == "einsum" or s <= q_block:
            mask = _mask(positions[None], positions[None], cfg.window)
            o = _sdpa(q, k, v, mask, scale)
        elif impl == "blocked":
            o = blocked_sdpa(q, k, v, positions, cfg.window, scale, q_block)
        else:
            raise ValueError(impl)
    o = o.reshape(b, s, q.shape[2] * cfg.head_dim)
    return out_proj(o, p["wo"], d, lay)


def kv_to_ring(k: torch.Tensor, lay, ring) -> torch.Tensor:
    """New K/V rows (B,·,KVh,hd) as computed (the KV heads of
    :func:`_qkv_local`) in the ring's KV-head layout: gathered over the
    heads' axes where the ring keeps every KV head, cut to the ring's
    block where it shards them."""
    if lay is None:
        return k
    whole = lay.kv is None
    ck = ring[1]
    if ck is None and not whole:
        return lay.kv.all_gather(k, 2)
    if ck is not None and whole:
        return ck.local(k, 2)
    return k


def ring_kv_len(pos: int, sc: int, cs) -> int:
    """Filled slots of this rank's block of a ring of ``sc`` slots at
    absolute position ``pos`` (after its write).  The ring holds the last
    ``min(pos + 1, sc)`` positions in slots ``0 .. min(pos + 1, sc) - 1``
    (prefill fills slots ``0..s-1``, or all of them; decode writes slot
    ``pos % sc``), so a block of slots ``[lo, lo + n)`` holds
    ``clamp(min(pos + 1, sc) - lo, 0, n)`` of them."""
    filled = min(pos + 1, sc)
    if cs is None:
        return filled
    n = sc // cs.size
    return max(0, min(filled - cs.index() * n, n))


def attention_decode(cfg: ModelConfig, p, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     slot_pos: torch.Tensor, pos: int, lay=None, ring=None):
    """One-token decode with a ring-buffer KV cache.

    x (B,1,D); k_cache/v_cache (B,Sc,KV,hd); slot_pos (Sc,) stored
    position per slot (-1 = empty); ``pos`` (a Python int) = current
    absolute position.  Writes the new K/V into slot ``pos % Sc`` of the
    caches and ``pos`` into ``slot_pos``, in place, and returns
    (out (B,1,D), k_cache, v_cache, slot_pos).

    GQA reads the cache without repeating it.  With ``cfg.attn_impl ==
    "pallas"`` the attention is ``ops.decode_attention`` over the ring
    with ``kv_len = min(pos + 1, Sc)`` and no window: the ring holds
    exactly the last ``min(pos + 1, Sc)`` positions (:func:`ring_kv_len`;
    ``Sc = min(max_len, window)``), which are the slots the JAX
    function's ``slot_pos``/window mask keeps, and the softmax does not
    depend on their order.  Otherwise the JAX function's einsum over the
    masked ring.

    Over a mesh the caches are this rank's block (its rows of the batch,
    its slots where ``ring[0]`` shards them, its KV heads where
    ``ring[1]`` does; ``slot_pos`` whole): only the rank holding slot
    ``pos % Sc`` writes it, and where the slots are sharded each rank
    attends over its own (the kernel over its filled ones, giving the
    log-sum-exp too) and the ranks combine their partial softmaxes: the
    split-KV formula of the JAX function's sharded scores.  Where the
    slots and the query heads are sharded over the same axes, the query is
    gathered to every head first: each rank attends with every head over
    its slots, then keeps its heads' columns for the row-parallel
    ``wo``."""
    b = x.shape[0]
    hd = cfg.head_dim
    cs = None if ring is None else ring[0]
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv_local(cfg, p, x, positions, lay)
    k, v = kv_to_ring(k, lay, ring), kv_to_ring(v, lay, ring)
    all_heads = (cs is not None and lay.heads is not None
                 and bool(set(cs.axes) & set(lay.heads.axes)))
    if all_heads:
        q = lay.heads.all_gather(q, 2)
    sc = slot_pos.shape[0]
    slot = pos % sc
    n = k_cache.shape[1]                  # this rank's slots
    lo = 0 if cs is None else cs.index() * n
    if lo <= slot < lo + n:
        k_cache[:, slot - lo] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot - lo] = v[:, 0].to(v_cache.dtype)
    slot_pos[slot:slot + 1].fill_(pos)   # a fill: item assignment syncs
    whole = ring is None or ring[1] is None
    kc, group = kv_for_heads(cfg, k_cache, lay, whole, all_heads)
    vc, _ = kv_for_heads(cfg, v_cache, lay, whole, all_heads)
    kvh, hq = kc.shape[2], q.shape[2]
    scale = hd ** -0.5
    if cfg.attn_impl == "pallas":
        kl = ring_kv_len(pos, sc, cs)
        qk = q[:, 0].to(k_cache.dtype)
        if cs is None:
            o = ops.decode_attention(qk, kc.permute(0, 2, 1, 3),
                                     vc.permute(0, 2, 1, 3), kv_len=kl,
                                     scale=scale)
        else:
            o, lse = ops.decode_attention(qk, kc.permute(0, 2, 1, 3),
                                          vc.permute(0, 2, 1, 3),
                                          kv_len=kl, scale=scale,
                                          return_lse=True)
            top = cs.pmax(lse)
            w = torch.exp(lse - top)
            o = (cs.psum(o.to(torch.float32) * w[..., None])
                 / cs.psum(w)[..., None])
        o = o.to(x.dtype).reshape(b, 1, hq * hd)
    else:
        f32 = torch.float32
        q5 = q.reshape(b, 1, kvh, group, hd).to(k_cache.dtype).to(f32)
        s = torch.einsum("bqkgh,btkh->bkgqt", q5,
                         kc.to(f32)) * scale                # (B,KV,G,1,Sc)
        sp = slot_pos[lo:lo + n]
        valid = (sp >= 0) & (sp <= pos)
        if cfg.window is not None:
            valid &= sp > pos - cfg.window
        s = torch.where(valid[None, None, None, None, :], s,
                        torch.tensor(_NEG, dtype=f32, device=s.device))
        if cs is None:
            a = torch.softmax(s, dim=-1)
        else:
            e = torch.exp(s - cs.pmax(s.amax(-1, keepdim=True)))
            a = e / cs.psum(e.sum(-1, keepdim=True))
        o = torch.einsum("bkgqt,btkh->bqkgh", a.to(v_cache.dtype).to(f32),
                         vc.to(f32))
        if cs is not None:
            o = cs.psum(o)
        o = o.to(x.dtype).reshape(b, 1, hq * hd)
    out = out_proj(o, p["wo"], x.shape[-1], lay, all_heads)
    return out, k_cache, v_cache, slot_pos


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(p, x: torch.Tensor, lay=None) -> torch.Tensor:
    """SwiGLU; over a mesh column-parallel gate/up and row-parallel down
    over ``lay.ff``, then ``psum``."""
    c = None if lay is None else lay.ff
    x = copy_to(c, x)
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(x.dtype))
    return reduce_from(c, torch.einsum("bsf,fd->bsd", F.silu(g) * u,
                                       p["w_down"].to(x.dtype)))


# ---------------------------------------------------------------------------
# MoE (fixed-capacity sort-and-dispatch; per-sequence capacity)
# ---------------------------------------------------------------------------

def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_row(x, eid, tok, n_experts: int, cap: int):
    """Every sequence at once: route its S·k (token, expert) slots into
    (E, cap) buffers.  x (B,S,D), eid/tok (B,L) -> buf (B,E·cap,D) and
    per row the slot, order and ok of each sorted route.  Routes beyond
    an expert's capacity go to a trash slot E·cap, which is dropped."""
    b, l = eid.shape
    order = torch.sort(eid, dim=1, stable=True).indices
    sorted_eid = torch.gather(eid, 1, order)
    first = torch.searchsorted(sorted_eid, sorted_eid, side="left")
    rank = (torch.arange(l, device=eid.device)[None, :] - first)
    ok = rank < cap
    slot = torch.where(ok, sorted_eid * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    rows = n_experts * cap + 1
    flat = (torch.arange(b, device=x.device)[:, None] * rows + slot)
    src = torch.gather(tok, 1, order)
    buf = x.new_zeros((b * rows, x.shape[-1]))
    buf[flat[ok]] = x[torch.arange(b, device=x.device)[:, None]
                      .expand(b, l)[ok], src[ok]]
    return buf.view(b, rows, -1)[:, :-1], slot, order, ok


def _moe_dispatch_ffn(cfg: ModelConfig, p, x, top_e, top_w):
    """Dispatch → expert SwiGLU → combine, on one device.

    The combine sums each token's k contributions in the order the JAX
    package's scatter-add applies them — its routes sorted stably by
    expert id, starting from zero — rounding in the working dtype after
    each add, so the sum does not depend on the order atomics land in."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = int(math.ceil(s * k / e * cfg.capacity_factor))
    eid = top_e.reshape(b, s * k)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)
    tok = tok[None, :].expand(b, s * k)
    w = top_w.reshape(b, s * k)

    buf, slot, order, ok = _dispatch_row(x, eid, tok, e, cap)
    buf = buf.reshape(b, e, cap, d)
    g = torch.einsum("becd,edf->becf", buf, p["w_gate"].to(x.dtype))
    u = torch.einsum("becd,edf->becf", buf, p["w_up"].to(x.dtype))
    y_buf = torch.einsum("becf,efd->becd", F.silu(g) * u,
                         p["w_down"].to(x.dtype)).reshape(b, e * cap, d)
    y_buf = torch.cat([y_buf, y_buf.new_zeros((b, 1, d))], 1)

    gain = torch.where(ok, torch.gather(w, 1, order),
                       torch.zeros((), dtype=w.dtype, device=w.device))
    contrib = (torch.gather(y_buf, 1, slot[..., None].expand(b, s * k, d))
               * gain[..., None].to(y_buf.dtype))      # sorted route order
    # back to (token, slot) order, then each token's routes by expert id
    pos = torch.empty_like(order)
    pos.scatter_(1, order, torch.arange(s * k, device=x.device)
                 .expand(b, s * k))
    pos = torch.sort(pos.reshape(b, s, k), dim=-1).values
    parts = torch.gather(contrib, 1, pos.reshape(b, s * k, 1)
                         .expand(b, s * k, d)).reshape(b, s, k, d)
    y = torch.zeros((b, s, d), dtype=y_buf.dtype, device=x.device)
    for j in range(k):
        y = y + parts[:, :, j]
    return y


def _batch_mean(x: torch.Tensor, lay) -> torch.Tensor:
    """Mean over dims (0, 1) of the global batch: a ``psum`` of the rows'
    sums over ``lay.batch`` before the division (the mean of per-shard
    means differs where the product with another mean follows)."""
    if lay is None or lay.batch is None:
        return x.mean((0, 1))
    n = x.shape[0] * lay.batch.size * x.shape[1]
    return reduce_from(lay.batch, x.sum((0, 1))) / n


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor, lay=None):
    """Top-k MoE with per-sequence capacity. x (B,S,D) -> (y, aux_loss).

    Two dispatch paths over a mesh (``cfg.moe_impl``), as the JAX
    package's:

    * ``shard_map`` (default) — dispatch, expert SwiGLU and combine on
      this rank's rows of the batch (exact: the dispatch is per
      sequence), ``moe_ff`` row-parallel over ``lay.moe_ff``, one
      ``psum`` of y;
    * ``gspmd`` — the batch all-gathered over its axes and the whole
      batch's experts computed on every rank (the redundant FLOPs the
      partitioner's layout costs, DESIGN.md), then this rank's rows.

    S == 1 (decode) uses the dense all-expert combine, ``moe_ff`` sharded,
    then ``psum``.  The load-balancing loss is ``e · Σ frac_tokens ·
    frac_prob`` of the global batch: both means are summed over the batch
    axes before their product."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", x, p["router"].to(x.dtype)
                          ).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, k)                          # (B,S,k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # load-balancing aux (switch-style)
    sel = F.one_hot(top_e, e).to(torch.float32).sum(2)      # (B,S,E)
    frac_tokens = _batch_mean(sel, lay) / k
    frac_prob = _batch_mean(probs, lay)
    aux = e * torch.sum(frac_tokens * frac_prob)
    mf = None if lay is None else lay.moe_ff

    if s == 1:
        # dense all-expert combine
        xf = copy_to(mf, x)
        g = torch.einsum("bqd,edf->beqf", xf, p["w_gate"].to(x.dtype))
        u = torch.einsum("bqd,edf->beqf", xf, p["w_up"].to(x.dtype))
        y_all = torch.einsum("beqf,efd->beqd", F.silu(g) * u,
                             p["w_down"].to(x.dtype))
        comb = torch.zeros((b, e), dtype=torch.float32, device=x.device)
        comb = comb.scatter_add(1, top_e[:, 0], top_w[:, 0])
        y = torch.einsum("beld,be->bld", y_all.to(torch.float32),
                         copy_to(mf, comb))
        return reduce_from(mf, y).to(x.dtype), aux

    rows = None
    if (lay is not None and lay.batch is not None
            and (cfg.moe_impl != "shard_map" or not lay.batch_even)):
        # the gspmd path: the batch gathered; the backward keeps this
        # rank's rows of the cotangent, exact since the dispatch does not
        # mix rows (another rank's cotangent of these rows is zero)
        rows = lay.batch
        x = gather_from(rows, x, 0)
        top_e = rows.all_gather(top_e, 0)
        top_w = gather_from(rows, top_w, 0)
    y = _moe_dispatch_ffn(cfg, p, copy_to(mf, x), top_e,
                          copy_to(mf, top_w.to(x.dtype)))
    y = reduce_from(mf, y)
    if rows is not None:
        y = rows.local(y, 0)
    return y.to(x.dtype), aux


def moe_dropped_fraction(cfg: ModelConfig, p, x: torch.Tensor):
    """Diagnostics: fraction of (token, slot) routes dropped by capacity."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", x, p["router"].to(x.dtype))
    _, top_e = top_k(logits.to(torch.float32), k)
    cap = int(math.ceil(s * k / e * cfg.capacity_factor))
    eid = top_e.reshape(b, s * k)
    counts = torch.zeros((b, e), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, eid, torch.ones_like(eid))
    dropped = torch.clamp(counts - cap, min=0).sum()
    return dropped / (b * s * k)
