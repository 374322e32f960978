"""Parity of the port's ``kernels.ops.decode_attention`` with the JAX
package on the CPU.  On CPU tensors the op runs its plain version
(``kernels.ref.decode_attention_ref``); it is held against the JAX op —
the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it
— and against the JAX reference, on the same inputs made from a numpy
seed, at every shape and dtype of ``tests/test_kernels.py``'s decode test
and its tolerances (fp32 2e-5, bf16 2e-2).  The CUDA kernel itself is
held against the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here its wrapper's argument checks run."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.kernels import decode_attention as KD
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, b, hq, hkv, s, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d))]
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _check(got, jax_out, dtype):
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jax_out, np.float32), **TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,s,d,kv_len,window", [
    (2, 4, 2, 512, 64, 512, None),
    (1, 8, 8, 1024, 64, 700, None),    # padded cache
    (2, 4, 1, 512, 128, 512, 128),     # sliding window
    (1, 2, 2, 300, 32, 300, None),     # ragged skv
    (1, 16, 2, 512, 128, 500, 256),    # GQA group 8 at D 128, windowed
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_shapes(b, hq, hkv, s, d, kv_len, window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(s + d + kv_len, b, hq, hkv, s, d,
                                      dtype)
    got = ops.decode_attention(q, k, v, kv_len=kv_len, window=window)
    assert got.shape == (b, hq, d)
    _check(got, jops.decode_attention(jq, jk, jv, kv_len=kv_len,
                                      window=window, bk=256), dtype)
    _check(got, jref.decode_attention_ref(jq, jk, jv, kv_len=kv_len,
                                          window=window), dtype)
    assert torch.equal(got, ops.decode_attention(q, k, v, kv_len=kv_len,
                                                 window=window,
                                                 use_kernels=False))


@pytest.mark.parametrize("d", [24, 37, 48, 80, 96])
def test_decode_attention_head_dims(d):
    """Head dims the kernel runs as they are (multiples of 8: 24, nemo-
    smoke's; 48; 80, h2o-danube-1.8b's; 96) or zero-padded (37, odd),
    fp32, windowed: the plain version against the Pallas kernel in
    interpret mode and the JAX reference."""
    (jq, jk, jv), (q, k, v) = _inputs(d, 2, 4, 2, 300, d, "float32")
    got = ops.decode_attention(q, k, v, kv_len=290, window=100)
    assert got.shape == (2, 4, d)
    _check(got, jops.decode_attention(jq, jk, jv, kv_len=290, window=100,
                                      bk=256), "float32")
    _check(got, jref.decode_attention_ref(jq, jk, jv, kv_len=290,
                                          window=100), "float32")


@pytest.mark.parametrize("d,hq,hkv", [(192, 4, 2), (256, 16, 8),
                                      (320, 16, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_head_dims_above_128(d, hq, hkv, dtype):
    """Head dims above 128 (Gemma-2-9B's 256 at its 16 / 8 heads) and a
    GQA group of 16 at D 320 (where the kernel splits the group and O's
    columns over blocks), windowed: the plain version against the Pallas
    kernel in interpret mode and the JAX reference."""
    (jq, jk, jv), (q, k, v) = _inputs(d, 1, hq, hkv, 128, d, dtype)
    got = ops.decode_attention(q, k, v, kv_len=120, window=100)
    assert got.shape == (1, hq, d)
    _check(got, jops.decode_attention(jq, jk, jv, kv_len=120, window=100,
                                      bk=256), dtype)
    _check(got, jref.decode_attention_ref(jq, jk, jv, kv_len=120,
                                          window=100), dtype)


@pytest.mark.parametrize("d", [37, 100, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_the_head_dim_is_exact(d, dtype):
    """The wrapper's padding, on the plain version: q and the keys and
    values up to ``kv_len`` with zero columns up to the next multiple of
    8, at the original D's scale, sliced back, give the unpadded call's
    output bit for bit, and its log-sum-exp up to the order of the host's
    float32 sums."""
    _, (q, k, v) = _inputs(d, 2, 4, 2, 90, d, dtype)
    dp = -(-d // KD.HEAD_DIM_STEP) * KD.HEAD_DIM_STEP
    assert dp == {37: 40, 100: 104, 300: 304}[d]
    for kv_len, window in ((90, None), (60, 25)):
        padded = [KD.pad_head_dim(x, dp) for x in (q, k[:, :, :kv_len],
                                                   v[:, :, :kv_len])]
        got, lse = ref.decode_attention_ref(*padded, kv_len=kv_len,
                                            window=window, scale=d ** -0.5,
                                            return_lse=True)
        want, w_lse = ref.decode_attention_ref(q, k, v, kv_len=kv_len,
                                               window=window,
                                               return_lse=True)
        assert torch.equal(got[..., :d], want)
        torch.testing.assert_close(lse, w_lse, rtol=1e-6, atol=1e-6)


def test_meta_refuses_what_the_card_refuses():
    """The dry trace's decode call applies the wrapper's shape rules: a
    head dim of 0 both refuse alike; 24, 136, 256 and 320 both take (the
    card's rules, ``check_shapes``, pass; on the CPU the kernel then
    refuses the tensors for lying there)."""
    from repro_torch.analysis.ops import Trace

    def args(d, device):
        return (torch.zeros(1, 4, d, device=device),
                torch.zeros(1, 2, 8, d, device=device),
                torch.zeros(1, 2, 8, d, device=device))
    for call in (lambda d: KD.decode_attention(*args(d, "cpu")),
                 lambda d: KD.meta(*args(d, "meta"))):
        with pytest.raises(ValueError, match="head dim 0 not supported"):
            call(0)
    for d in (24, 136, 256, 320):
        KD.check_shapes(*args(d, "cpu"), kv_len=8, window=None)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            KD.decode_attention(*args(d, "cpu"))
    with Trace():
        for d in (24, 136, 256, 320):
            assert KD.meta(*args(d, "meta")).shape == (1, 4, d)
        with pytest.raises(ValueError, match="kv_len=9"):
            KD.meta(*args(64, "meta"), kv_len=9)


@pytest.mark.parametrize("kv_len,window", [(1, None), (77, 16), (200, 1),
                                           (200, 500)])
def test_decode_attention_over_a_permuted_cache_view(kv_len, window):
    """The serving path hands the op a (B, Hkv, S, D) permuted view of a
    (B, S, Hkv, D) ring; the result equals the contiguous cache's, and
    the JAX reference's."""
    rng = np.random.default_rng(kv_len)
    b, hq, hkv, s, d = 2, 6, 2, 200, 16
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    cache = [rng.standard_normal((b, s, hkv, d)).astype(np.float32)
             for _ in range(2)]
    k, v = (torch.from_numpy(c).permute(0, 2, 1, 3) for c in cache)
    assert not k.is_contiguous()
    got = ops.decode_attention(torch.from_numpy(q), k, v, kv_len=kv_len,
                               window=window, scale=0.3)
    assert torch.equal(got, ops.decode_attention(
        torch.from_numpy(q), k.contiguous(), v.contiguous(), kv_len=kv_len,
        window=window, scale=0.3))
    jk, jv = (jnp.asarray(c).transpose(0, 2, 1, 3) for c in cache)
    _check(got, jref.decode_attention_ref(jnp.asarray(q), jk, jv,
                                          kv_len=kv_len, window=window,
                                          scale=0.3), "float32")


def test_decode_attention_plain_version_is_the_reference():
    (_, _, _), (q, k, v) = _inputs(3, 2, 4, 2, 40, 32, "float32")
    assert torch.equal(ops.decode_attention(q, k, v, kv_len=30),
                       ref.decode_attention_ref(q, k, v, kv_len=30))
    assert torch.equal(ops.decode_attention(q, k, v),
                       ref.decode_attention_ref(q, k, v, kv_len=40))


def test_decode_attention_kernel_refuses_what_it_does_not_take():
    q = torch.zeros(1, 4, 64)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.decode_attention(q, k, k, use_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        KD.decode_attention(q, k, k)
    with pytest.raises(ValueError, match="backward"):
        KD.decode_attention(q.clone().requires_grad_(), k, k)
    with pytest.raises(ValueError, match="head dim 0"):
        KD.decode_attention(torch.zeros(1, 4, 0),
                            torch.zeros(1, 2, 8, 0),
                            torch.zeros(1, 2, 8, 0))
    with pytest.raises(ValueError, match="not supported"):
        KD.decode_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="multiple"):
        KD.decode_attention(torch.zeros(1, 3, 64), k, k)
    with pytest.raises(ValueError, match="kv_len=9"):
        KD.decode_attention(q, k, k, kv_len=9)
    with pytest.raises(ValueError, match="kv_len=0"):
        KD.decode_attention(q, k, k, kv_len=0)
    with pytest.raises(ValueError, match="window=0"):
        KD.decode_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="same strides"):
        KD.decode_attention(q, k, torch.zeros(1, 8, 2, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="unit stride"):
        KD.decode_attention(q, k, torch.zeros(1, 2, 64, 8).transpose(2, 3))
    with pytest.raises(ValueError, match="must be torch.float32"):
        KD.decode_attention(q, k.bfloat16(), k)
    assert KD.HEAD_DIM_STEP == 8
    assert KD.decode_attention.launches == 0


H100_SMS = 132


def _split_ranges(kv_len, window, kv_blocks, sm_count):
    """The key ranges [start, end) of ``split_plan``'s splits, as the
    kernel walks them: split i from tile t_first + i·per, clipped to
    [lo, kv_len)."""
    t_first, per, n = KD.split_plan(kv_len, window, kv_blocks, sm_count)
    lo = 0 if window is None else max(0, kv_len - window)
    return [(max(lo, (t_first + i * per) * 64),
             min(kv_len, (t_first + (i + 1) * per) * 64)) for i in range(n)]


@pytest.mark.parametrize("kv_len", [1, 64, 65, 2049, 4096])
@pytest.mark.parametrize("window", [None, 1, 16, 512])
@pytest.mark.parametrize("kv_blocks", [1, 32, 263, 264, 1000])
def test_split_plan_covers_the_keys_in_whole_tiles(kv_len, window,
                                                   kv_blocks):
    """The wrapper's split policy on a 132-SM card: ranges in order that
    cover [lo, kv_len) exactly, each starting on a tile boundary (or at
    lo) and none empty, all but the last of equal whole tiles; one split
    when B·Hkv fills two blocks per SM alone, and the grid never far past
    that target otherwise."""
    lo = 0 if window is None else max(0, kv_len - window)
    t_first, per, n = KD.split_plan(kv_len, window, kv_blocks, H100_SMS)
    ranges = _split_ranges(kv_len, window, kv_blocks, H100_SMS)
    assert len(ranges) == n and t_first == lo // 64 and per >= 1
    assert ranges[0][0] == lo and ranges[-1][1] == kv_len
    for (s0, e0), (s1, _) in zip(ranges, ranges[1:]):
        assert e0 == s1 and s1 % 64 == 0
    assert all(e > s for s, e in ranges)
    assert all((s1 - s0 + s0 % 64) == per * 64 for s0, s1 in ranges[:-1])
    n_tiles = (kv_len - 1) // 64 - lo // 64 + 1
    if kv_blocks >= 2 * H100_SMS:
        assert n == 1 and per == n_tiles
    else:
        assert n <= n_tiles
        assert kv_blocks * n < 2 * 2 * H100_SMS + kv_blocks * per


def test_split_plan_at_granite_moe_decode():
    """B 4 x Hkv 8 at kv_len 2049: 33 tiles in 9 splits of 4 (the last
    holds tile 32 alone, one key); 2047 gives 8 splits of 4."""
    assert KD.split_plan(2049, None, 32, H100_SMS) == (0, 4, 9)
    assert _split_ranges(2049, None, 32, H100_SMS)[-1] == (2048, 2049)
    assert KD.split_plan(2047, None, 32, H100_SMS) == (0, 4, 8)
    assert KD.split_plan(2049, None, 33 * 8, H100_SMS) == (0, 33, 1)


def _split_emulation(q, k, v, *, kv_len, window=None, scale=None,
                     sm_count=H100_SMS):
    """A plain emulation of the split-KV kernel's arithmetic in fp32: each
    split of ``_split_ranges`` walks its whole 64-key tiles (keys past the
    cache read as zeros), masks with -1e30 and weighs a masked key 0, and
    keeps (acc, m, l); the combine forms sum_s e^(m_s - m*) acc_s /
    max(sum_s e^(m_s - m*) l_s, 1e-30).  One split divides directly."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    qf = q.float().reshape(b, hkv, g, d) * scale
    lo = 0 if window is None else max(0, kv_len - window)
    parts = []
    for start, end in _split_ranges(kv_len, window, b * hkv, sm_count):
        m = torch.full((b, hkv, g), -1e30)
        l = torch.zeros((b, hkv, g))
        acc = torch.zeros((b, hkv, g, d))
        for t in range(start // 64 * 64, end, 64):
            kt, vt = (torch.nn.functional.pad(
                x[:, :, t:t + 64].float(), (0, 0, 0, max(0, t + 64 - s)))
                for x in (k, v))
            kpos = torch.arange(t, t + 64)
            keep = (kpos < kv_len) & (kpos >= lo)
            sc = torch.where(keep, torch.einsum("bhgd,bhkd->bhgk", qf, kt),
                             torch.tensor(-1e30))
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.where(keep, torch.exp(sc - m_new[..., None]),
                            torch.tensor(0.0))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgk,bhkd->bhgd",
                                                        p, vt)
            m = m_new
        parts.append((acc, m, l))
    if len(parts) == 1:
        acc, _, l = parts[0]
        out = acc / l.clamp_min(1e-30)[..., None]
    else:
        m_star = torch.stack([m for _, m, _ in parts]).amax(0)
        w = [torch.exp(m - m_star) for _, m, _ in parts]
        num = sum(wi[..., None] * acc for wi, (acc, _, _) in zip(w, parts))
        den = sum(wi * l for wi, (_, _, l) in zip(w, parts))
        out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d,kv_len,window,sm_count", [
    (4, 24, 8, 2176, 64, 2049, None, H100_SMS),   # 9 splits, last 1 key
    (4, 24, 8, 2176, 64, 2047, None, H100_SMS),   # 8 splits, last 1 short
    (1, 4, 2, 300, 32, 300, 100, H100_SMS),       # window from mid-tile
    (2, 6, 2, 700, 16, 650, 333, H100_SMS),       # window over splits
    (1, 8, 1, 1024, 128, 1, None, H100_SMS),      # one key
    (2, 8, 2, 512, 80, 500, None, 2),             # few splits, D 80
    (33, 16, 8, 130, 64, 129, None, H100_SMS),    # B·Hkv 264: one split
])
def test_split_combine_emulation_matches_the_reference(b, hq, hkv, s, d,
                                                       kv_len, window,
                                                       sm_count):
    (jq, jk, jv), (q, k, v) = _inputs(kv_len + d, b, hq, hkv, s, d,
                                      "float32")
    got = _split_emulation(q, k, v, kv_len=kv_len, window=window,
                           sm_count=sm_count)
    _check(got, jref.decode_attention_ref(jq, jk, jv, kv_len=kv_len,
                                          window=window), "float32")


@pytest.mark.parametrize("shift", [0, 1, 100, 4095])
def test_split_combine_emulation_over_a_wrapped_ring(shift):
    """A full ring whose slots hold the positions rotated by ``shift`` (as
    decode leaves it after the ring wraps), read through the permuted
    view: the split-and-combine emulation over the ring equals the JAX
    reference over the positions in order."""
    rng = np.random.default_rng(shift)
    b, hq, hkv, sc, d = 4, 24, 8, 4096, 64
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    cache = [rng.standard_normal((b, sc, hkv, d)).astype(np.float32)
             for _ in range(2)]
    ring = [torch.from_numpy(np.roll(c, shift, axis=1)).permute(0, 2, 1, 3)
            for c in cache]
    got = _split_emulation(torch.from_numpy(q), *ring, kv_len=sc)
    jk, jv = (jnp.asarray(c).transpose(0, 2, 1, 3) for c in cache)
    _check(got, jref.decode_attention_ref(jnp.asarray(q), jk, jv,
                                          kv_len=sc), "float32")
