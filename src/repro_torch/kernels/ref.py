"""Plain PyTorch versions of the port's CUDA kernels.

Port of ``repro.kernels.ref`` for the kernels the port has.  Each
function computes its kernel's result in the obvious way, on any device:
the CPU path of ``kernels.ops`` runs them, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card.  uint32 lanes are int32 bit
patterns (``core.bits``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.radix import HIST_BUCKETS, extract_digit

#: Rows per chunk of :func:`radix_rank_ref`'s one-hot prefix sums: the
#: (chunk, 256) int32 one-hot stays at 8 MiB whatever T is.
RANK_CHUNK = 8192

#: Elements of the largest intermediate of :func:`signature_ref` (int64)
#: and :func:`tricluster_density_ref` (float32): 2**25 of them, at most
#: 256 MiB, whatever the shapes.
CHUNK_ELEMS = 1 << 25


def segment_reduce_ref(w_lo: torch.Tensor, w_hi: torch.Tensor,
                       first: torch.Tensor):
    """Fused masked prefix sums: inclusive cumsums of first-occurrence-
    masked uint32 hash weights (mod 2**32) and of the mask itself.

    w_lo, w_hi: (T,) int32 bit patterns; first: (T,) bool/0-1.
    Returns three (T,) int32 tensors."""
    f = first.to(torch.bool)
    zero = torch.zeros((), dtype=torch.int32, device=w_lo.device)
    lo = torch.cumsum(torch.where(f, w_lo, zero), 0, dtype=torch.int32)
    hi = torch.cumsum(torch.where(f, w_hi, zero), 0, dtype=torch.int32)
    cnt = torch.cumsum(f.to(torch.int32), 0, dtype=torch.int32)
    return lo, hi, cnt


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as the int32 bit patterns of their low 32 bits."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def segment_reduce_tiled(w_lo: torch.Tensor, w_hi: torch.Tensor,
                         first: torch.Tensor, tile: Optional[int] = None,
                         items: Optional[int] = None, lag: int = 0):
    """:func:`segment_reduce_ref` computed as the CUDA sweep decomposes it
    (``kernels.segment_reduce``: tiles of ``tile`` elements, default
    ``TILE``, ``items`` elements a thread, default ``ITEMS``), in the
    exclusive (T + 1) layout it writes, on any device.

    A warp holds a stretch of 32 x ``items`` elements of its tile as
    chunks of 128, a lane the 4 contiguous elements 4l .. 4l + 3 of each
    chunk: the lane's elements are scanned in turn, the lane sums of a
    chunk across the warp, the chunk totals carry from chunk to chunk,
    and the warp totals are scanned across the tile (each warp's start);
    each tile publishes its three lane totals.  Then, tile after tile in
    the order they are claimed, each of the three lanes walks back over
    its own status words alone: the nearest ``lag`` predecessors still
    hold AGGREGATE values (published, not yet inclusive) and are added one
    by one, and the next one's INCLUSIVE value ends the walk.  The ragged
    last tile is zero past T, and element T is the last tile's inclusive
    value.  Returns three (T + 1,) int32 tensors (uint32 bit patterns for
    the weight lanes)."""
    from .segment_reduce import ITEMS, TILE
    tile = tile or TILE
    items = items or ITEMS
    if items % 4 or tile % (32 * items):
        raise ValueError(f"a tile of {tile} does not split into warps of "
                         f"32 x {items} elements in chunks of 128")
    t = w_lo.shape[0]
    dev = w_lo.device
    f = first.to(torch.bool)
    ntiles = max(1, -(-t // tile))
    lanes = torch.zeros((3, ntiles * tile), dtype=torch.int64, device=dev)
    lanes[0, :t] = torch.where(f, w_lo.long() & 0xFFFFFFFF, 0)
    lanes[1, :t] = torch.where(f, w_hi.long() & 0xFFFFFFFF, 0)
    lanes[2, :t] = f.long()
    # (lane of the sums, tile, warp, chunk, lane of the warp, element)
    v = lanes.view(3, ntiles, tile // (32 * items), items // 4, 32, 4)
    in_lane = torch.cumsum(v, -1) - v
    lane_sum = v.sum(-1)
    in_chunk = torch.cumsum(lane_sum, -1) - lane_sum
    chunk_sum = lane_sum.sum(-1)
    in_warp = torch.cumsum(chunk_sum, -1) - chunk_sum
    warp_sum = chunk_sum.sum(-1)
    in_tile = torch.cumsum(warp_sum, -1) - warp_sum
    agg = warp_sum.sum(-1)                            # (3, ntiles)
    inclusive = torch.zeros_like(agg)
    prefix = torch.zeros_like(agg)
    for k in range(ntiles):                           # claim order
        for lane in range(3):
            p, j = 0, k - 1
            while j >= 0:
                if j >= k - lag:                      # still AGGREGATE
                    p += int(agg[lane, j])
                    j -= 1
                    continue
                p += int(inclusive[lane, j])          # INCLUSIVE: done
                break
            prefix[lane, k] = p
            inclusive[lane, k] = p + int(agg[lane, k])
    ex = (prefix[:, :, None, None, None, None]
          + in_tile[..., None, None, None] + in_warp[..., None, None]
          + in_chunk[..., None] + in_lane)
    out = torch.cat([ex.reshape(3, -1)[:, :t], inclusive[:, -1:]], 1)
    return tuple(_i32(x) for x in out)


def radix_histogram_ref(words: Sequence[torch.Tensor],
                        shifts: Sequence[int], widths: Sequence[int]
                        ) -> torch.Tensor:
    """All pruned digit histograms of the packed key words.

    words: 1-2 msb-first (T,) int32 words; shifts/widths: the radix
    plan's per-pass digit bit ranges. Returns (npass, 256) int32."""
    dev = words[0].device
    rows = []
    for shift, width in zip(shifts, widths):
        d = extract_digit(words, shift, width).to(torch.int64)
        ones = torch.ones_like(d, dtype=torch.int32)
        rows.append(torch.zeros((HIST_BUCKETS,), dtype=torch.int32,
                                device=dev).index_add_(0, d, ones))
    if not rows:
        return torch.zeros((0, HIST_BUCKETS), dtype=torch.int32, device=dev)
    return torch.stack(rows)


def radix_histogram_warp(words: Sequence[torch.Tensor],
                         shifts: Sequence[int], widths: Sequence[int],
                         blocks: int = 1):
    """:func:`radix_histogram_ref` computed as the CUDA sweep counts
    (``kernels.radix_sort.hist_plan``), on any device -> (the (npass,
    256) int32 histograms, the shared-memory additions the counts took).

    The grid of ``blocks`` blocks deals the vectors of 4 keys in equal
    contiguous shares; a warp's 32 lanes hold 32 consecutive vectors of
    its block's share and count one key of each vector at a time, in
    every pass, with one shared atomic.  The card adds the lanes of one
    such atomic that hit one bucket in one operation (``ATOMS.POPC.INC``),
    which this emulates as the warp multi-split: each lane's peers are the
    lanes that agree with it on every digit bit (one ballot per bit of the
    digit's width), and the lowest peer adds their number, one addition
    per distinct digit of the warp's 32 keys."""
    from .radix_sort import HIST_KEYS
    dev = words[0].device
    t = words[0].shape[0]
    npass = len(shifts)
    hist = torch.zeros((npass, HIST_BUCKETS), dtype=torch.int64, device=dev)
    if t == 0 or npass == 0:
        return hist.to(torch.int32), 0
    nvec = -(-t // HIST_KEYS)
    per = -(-nvec // blocks)
    warps = -(-per // 32)
    vec = torch.arange(nvec, device=dev)
    row = (vec // per) * warps + (vec % per) // 32   # the warp's step
    lane = vec % per % 32
    e = vec[:, None] * HIST_KEYS + torch.arange(HIST_KEYS, device=dev)
    lower = torch.ones((32, 32), dtype=torch.bool, device=dev).tril(-1)
    additions = 0
    for p, (shift, width) in enumerate(zip(shifts, widths)):
        dig = torch.full((t + HIST_KEYS,), -1, dtype=torch.int64,
                         device=dev)
        dig[:t] = extract_digit(words, shift, width).long()
        d = torch.full((blocks * warps, HIST_KEYS, 32), -1,
                       dtype=torch.int64, device=dev)
        d[row, :, lane] = dig[e.clamp(max=t)]
        d = d.reshape(-1, 32)
        live = d >= 0
        bits = (d.clamp(min=0)[..., None]
                >> torch.arange(width, device=dev)) & 1     # (R, 32, width)
        peers = ((bits[:, :, None, :] == bits[:, None, :, :]).all(-1)
                 & live[:, None, :] & live[:, :, None])
        leader = live & ~(peers & lower).any(-1)
        hist[p].index_add_(0, d[leader], peers[leader].sum(-1))
        additions += int(leader.sum())
    return hist.to(torch.int32), additions


def radix_rank_ref(digits: torch.Tensor, starts: torch.Tensor,
                   chunk: int = RANK_CHUNK) -> torch.Tensor:
    """Stable LSD-pass ranks: rank[i] = starts[d_i] + #{j<i : d_j==d_i}.

    digits: (T,) int32 in [0, 256); starts: (256,) int32 exclusive
    bucket starts. Returns (T,) int32 destination positions.  The one-hot
    prefix sum runs over ``chunk`` rows at a time, carrying the per-digit
    counts from chunk to chunk."""
    cols = torch.arange(HIST_BUCKETS, dtype=torch.int32,
                        device=digits.device)
    carry = starts.to(torch.int32).clone()
    out = torch.empty(digits.shape, dtype=torch.int32, device=digits.device)
    for lo in range(0, digits.shape[0], chunk):
        d = digits[lo:lo + chunk]
        oh = (d[:, None] == cols[None, :]).to(torch.int32)
        occ = torch.cumsum(oh, 0, dtype=torch.int32) - oh
        out[lo:lo + chunk] = (oh * (occ + carry[None, :])).sum(
            1, dtype=torch.int32)
        carry += oh.sum(0, dtype=torch.int32)
    return out


def radix_rank_tiled(digits: torch.Tensor, starts: torch.Tensor,
                     tile: Optional[int] = None,
                     warps: Optional[int] = None) -> torch.Tensor:
    """:func:`radix_rank_ref` computed as the CUDA rank sweep decomposes
    it (``kernels.radix_sort``: tiles of ``tile`` elements, default
    ``RANK_TILE``, of ``warps`` contiguous sub-ranges, default
    ``RANK_WARPS``), on any device: each tile's count of each digit (what
    it publishes), their exclusive prefix over the tiles (what its
    look-back adds up), each warp's start inside its tile, and each
    element's rank among the equal digits of its warp's sub-range."""
    from .radix_sort import RANK_TILE, RANK_WARPS
    tile = tile or RANK_TILE
    warps = warps or RANK_WARPS
    if tile % warps:
        raise ValueError(f"a tile of {tile} does not split into {warps} "
                         "warps")
    dev = digits.device
    t = digits.shape[0]
    ntiles = -(-t // tile)
    pos = torch.arange(t, device=dev)
    group = (pos // tile) * warps + (pos % tile) // (tile // warps)
    key = group * HIST_BUCKETS + (digits & (HIST_BUCKETS - 1)).long()
    counts = torch.zeros((ntiles * warps * HIST_BUCKETS,), dtype=torch.int64,
                         device=dev).index_add_(
        0, key, torch.ones_like(key)).view(ntiles, warps, HIST_BUCKETS)
    tile_counts = counts.sum(1)
    before_tile = torch.cumsum(tile_counts, 0) - tile_counts
    before_warp = torch.cumsum(counts, 1) - counts
    base = (starts.long()[None, None, :] + before_tile[:, None, :]
            + before_warp).reshape(-1)
    # rank inside the warp: position in a stable sort by (warp, digit)
    order = torch.sort(key, stable=True).indices
    first = torch.cumsum(counts.reshape(-1), 0) - counts.reshape(-1)
    local = torch.empty_like(key)
    local[order] = torch.arange(t, device=dev) - first[key[order]]
    return (base[key] + local).to(torch.int32)


def radix_pass_ref(words: Sequence[torch.Tensor],
                   perm: Optional[torch.Tensor], shift: int, width: int,
                   starts: torch.Tensor):
    """One LSD pass: each element's digit (bits [shift, shift + width) of
    the words, ``core.radix.extract_digit``), its stable rank
    (:func:`radix_rank_ref`), and the words and payload moved there.

    words: 1-2 msb-first (T,) int32 words in their current order; perm:
    (T,) int32 payload, None for ``arange(T)``; starts: (256,) int32
    bucket starts of the digit.  Returns (words, payload) in the pass's
    order."""
    rank = radix_rank_ref(extract_digit(words, shift, width),
                          starts).long()
    if perm is None:
        perm = torch.arange(words[0].shape[0], dtype=torch.int32,
                            device=words[0].device)
    out = []
    for w in (*words, perm):
        o = torch.empty_like(w)
        o[rank] = w
        out.append(o)
    return tuple(out[:-1]), out[-1]


def _attn_mask(sq: int, skv: int, q_offset: int, causal: bool,
               window: Optional[int], device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        q_offset: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention. q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D);
    GQA via head-group broadcast (query head h reads kv head h // group).
    fp32 softmax; ``q_offset`` (the position of q row 0) defaults to
    Skv - Sq.  Output in q's dtype."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    if q_offset is None:
        q_offset = skv - sq
    if scale is None:
        scale = d ** -0.5
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    qf = qf.reshape(b, hkv, group, sq, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    mask = _attn_mask(sq, skv, q_offset, causal, window, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return out.reshape(b, hq, sq, d).to(q.dtype)


#: The bf16 flash gate, elementwise against a float64 evaluation on the
#: same bf16 inputs: |o - o64| <= RTOL (|o64| + (P64 |V|) / l64) + ATOL.
#: The terms: P rounded to bf16 before the P·V product (unit roundoff
#: 2**-8, relative to P |V|), the output's own rounding (2**-8 of |o|),
#: and a factor 2 for the fp32 sums and exp.
BF16_FLASH_RTOL = 2.0 ** -7
BF16_FLASH_ATOL = 1e-5


def flash_bf16_gate(got: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    q_offset: Optional[int] = None,
                    scale: Optional[float] = None) -> float:
    """max over the elements of |got - o64| / (BF16_FLASH_RTOL (|o64| +
    (P64 |V|) / l64) + BF16_FLASH_ATOL), where o64 and P64 |V| / l64 come
    from a float64 evaluation of :func:`flash_attention_ref`'s function
    on the same inputs (one batch and kv head at a time).  ``got`` passes
    the gate when this is at most 1; NaN anywhere gives NaN."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    if q_offset is None:
        q_offset = skv - sq
    if scale is None:
        scale = d ** -0.5
    mask = _attn_mask(sq, skv, q_offset, causal, window, q.device)
    worst = torch.zeros((), dtype=torch.float64, device=q.device)
    for i in range(b):
        for j in range(hkv):
            heads = slice(j * group, (j + 1) * group)
            s = (q[i, heads].double() * scale) @ k[i, j].double().T
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            vd = v[i, j].double()
            o, o_abs = p @ vd, p @ vd.abs()
            err = (got[i, heads].double() - o).abs() / (
                BF16_FLASH_RTOL * (o.abs() + o_abs) + BF16_FLASH_ATOL)
            worst = torch.maximum(worst, err.max())
    return float(worst)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: Optional[int] = None,
                         kv_len: Optional[int] = None,
                         scale: Optional[float] = None,
                         return_lse: bool = False):
    """Single-token decode. q: (B, Hq, D); k, v: (B, Hkv, S, D), any
    strides. The query position is kv_len-1 (attends to keys
    [max(0, kv_len-window), kv_len)).  ``return_lse``: also the fp32
    log-sum-exp of the scaled scores over those keys, (B, Hq); a
    ``kv_len`` of 0 then gives o = 0 and lse = -inf (the empty block of a
    ring whose slots are split over ranks)."""
    s = k.shape[2]
    if kv_len is None:
        kv_len = s
    if kv_len == 0:
        if not return_lse:
            raise ValueError("decode_attention: kv_len=0 needs "
                             "return_lse=True")
        return (torch.zeros_like(q),
                torch.full(q.shape[:2], float("-inf"), dtype=torch.float32,
                           device=q.device))
    out = flash_attention_ref(q[:, :, None, :], k, v, causal=True,
                              window=window, q_offset=kv_len - 1,
                              scale=scale)
    if not return_lse:
        return out[:, :, 0, :]
    b, hq, d = q.shape
    hkv = k.shape[1]
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, d) * (
        d ** -0.5 if scale is None else scale)
    logits = torch.einsum("bhgd,bhkd->bhgk", qf, k.to(torch.float32))
    mask = _attn_mask(1, s, kv_len - 1, True, window, q.device)[0]
    lse = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), -1)
    return out[:, :, 0, :], lse.reshape(b, hq)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm rows of x (..., D) with fp32 statistics, in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def signature_ref(mask: torch.Tensor, r: torch.Tensor,
                  chunk_elems: int = CHUNK_ELEMS) -> torch.Tensor:
    """Order-independent set signatures: sig[t] = Σ_e mask[t,e]·r[e]
    mod 2**32.

    mask: (T, E) 0/1 of bool, uint8, int32 or float32; r: (E,) int32 bit
    patterns.  Returns (T,) int32 bit patterns.  The sum is taken in int64
    (each term is below 2**32, so E < 2**31 terms cannot overflow) and
    reduced mod 2**32 at the end, over row chunks of at most
    ``chunk_elems`` mask elements."""
    t, e = mask.shape
    r64 = r.to(torch.int64) & 0xFFFFFFFF
    out = torch.empty((t,), dtype=torch.int32, device=mask.device)
    rows = max(1, chunk_elems // max(e, 1))
    for lo in range(0, t, rows):
        m = mask[lo:lo + rows].to(torch.int64)
        s = (m * r64[None, :]).sum(1) & 0xFFFFFFFF
        out[lo:lo + rows] = torch.where(s >= 1 << 31, s - (1 << 32),
                                        s).to(torch.int32)
    return out


def tricluster_density_ref(tensor: torch.Tensor, x: torch.Tensor,
                           y: torch.Tensor, z: torch.Tensor,
                           chunk_elems: int = CHUNK_ELEMS) -> torch.Tensor:
    """Exact tricluster box-count numerators |X_t × Y_t × Z_t ∩ I|.

    tensor: (G, M, B) 0/1; x: (T, G); y: (T, M); z: (T, B), any dtype
    holding 0/1.  Returns (T,) float32.  Factored as the Pallas kernel
    factors it — ``C = Y @ I[g]`` (a float32 matrix product), then the sum
    over b weighted by Z, then the sum over g weighted by X — over chunks of
    T and G whose intermediates hold at most ``chunk_elems`` elements.
    Exact while the counts stay below 2**24."""
    g, m, b = tensor.shape
    t = x.shape[0]
    dev = tensor.device
    out = torch.zeros((t,), dtype=torch.float32, device=dev)
    if t == 0 or g == 0:
        return out
    rows = max(1, min(t, chunk_elems // max(m, b * 16, 1)))
    gc = max(1, min(g, chunk_elems // max(rows * b, m * b, 1)))
    for t0 in range(0, t, rows):
        yf = y[t0:t0 + rows].to(torch.float32)
        zf = z[t0:t0 + rows].to(torch.float32)
        xf = x[t0:t0 + rows].to(torch.float32)
        acc = torch.zeros((yf.shape[0],), dtype=torch.float32, device=dev)
        for g0 in range(0, g, gc):
            blk = tensor[g0:g0 + gc].to(torch.float32)      # (gc, M, B)
            n = blk.shape[0]
            c = yf @ blk.permute(1, 0, 2).reshape(m, n * b)  # (rows, gc*B)
            s = (c.reshape(-1, n, b) * zf[:, None, :]).sum(2)
            acc += (s * xf[:, g0:g0 + n]).sum(1)
        out[t0:t0 + rows] = acc
    return out


def tricluster_density_tiled(tensor: torch.Tensor, x: torch.Tensor,
                             y: torch.Tensor,
                             z: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel's decomposition of :func:`tricluster_density_ref`
    (``kernels.tricluster_density.Plan``) on any device (slow: a Python
    loop over its blocks).

    I is laid out as ``I'`` (N padded, M padded) with zero padding; each
    block of the raster order takes the int32 product of its (128 × Kp) Y
    rows, zero past T and M, with its (128 × Kp) ``I'`` rows; its epilogue
    weights each product by ``X[t,g(n)]·Z[t,b(n)]``, 0 past N, and adds
    the int64 row sums into (T,) sums, which are returned as float32."""
    from .tricluster_density import TILE_N, TILE_T, plan
    g, m, b = tensor.shape
    t = x.shape[0]
    dev = tensor.device
    p = plan(t, g, m, b)
    sums = torch.zeros((t,), dtype=torch.int64, device=dev)
    if t == 0 or p.n == 0 or m == 0:
        return sums.to(torch.float32)
    image = torch.zeros((p.n_pad, p.kp), dtype=torch.int32, device=dev)
    image[:p.n, :m] = (tensor != 0).permute(0, 2, 1).reshape(p.n, m)
    ypad = torch.zeros((p.tiles_t * TILE_T, p.kp), dtype=torch.int32,
                       device=dev)
    ypad[:t, :m] = y.to(torch.int32)
    xb, zb = (x != 0).to(torch.int64), (z != 0).to(torch.int64)
    for pid in range(p.blocks):
        tt, nt = p.tile(pid)
        t0, n0 = tt * TILE_T, nt * TILE_N
        rows = slice(t0, min(t0 + TILE_T, t))
        live = rows.stop - t0
        c = (ypad[t0:t0 + TILE_T] @ image[n0:n0 + TILE_N].T).to(torch.int64)
        cols = range(n0, min(n0 + TILE_N, p.n))
        gb = torch.tensor([p.column(n) for n in cols], device=dev)
        w = xb[rows][:, gb[:, 0]] * zb[rows][:, gb[:, 1]]
        sums[rows] += (c[:live, :len(cols)] * w).sum(1)
    return sums.to(torch.float32)


def row_counts(mask: torch.Tensor,
               chunk_elems: int = CHUNK_ELEMS) -> torch.Tensor:
    """(T, n) 0/1 mask -> (T,) float32 row sums, over row chunks of at
    most ``chunk_elems`` elements: a sum over a whole bool mask would
    first widen it to int64 (17 GB for the MovieLens-1M shape's mode-0
    fibers)."""
    t, n = mask.shape
    rows = max(1, chunk_elems // max(n, 1))
    out = torch.empty((t,), dtype=torch.float32, device=mask.device)
    for lo in range(0, t, rows):
        out[lo:lo + rows] = mask[lo:lo + rows].sum(-1).to(torch.float32)
    return out
