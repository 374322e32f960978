"""Parity of the port's ``kernels.ops.flash_attention`` with the JAX
package on the CPU.  On CPU tensors the op runs its plain version
(``kernels.ref.flash_attention_ref``); it is held against the JAX op —
the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it
— and against the JAX reference, on the same inputs made from a numpy
seed, at the tolerances of ``tests/test_kernels.py`` (fp32 2e-5, bf16
2e-2).  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``); here its wrapper's
argument checks run, and the float64 gate that holds the bf16 kernel
there (``ref.flash_bf16_gate``) is held against a plain emulation of the
kernel's arithmetic and against planted faults."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.analysis.ops import Trace, trace
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import ops, ref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(seed, b, hq, hkv, sq, skv, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]
    return ([jnp.asarray(a).astype(JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


def _check(got, jax_out, dtype):
    assert got.dtype == TDT[dtype]
    want = np.asarray(jax_out, np.float32)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               **TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (1, 4, 4, 128, 128, 64),      # MHA square
    (2, 8, 2, 128, 256, 64),      # GQA, kv longer (prefill continuation)
    (1, 4, 1, 64, 128, 128),      # MQA, sq not multiple of default bq
    (1, 2, 2, 200, 200, 32),      # ragged: no multiple of any tile
    (2, 6, 2, 96, 96, 16),        # head dim 16, GQA group 3
    (1, 16, 2, 72, 200, 128),     # GQA group 8 (internvl2-76b's), ragged
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_shapes(b, hq, hkv, sq, skv, d, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(sq + d, b, hq, hkv, sq, skv, d, dtype)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.shape == (b, hq, sq, d)
    _check(got, jops.flash_attention(jq, jk, jv, causal=True, bq=64, bk=64),
           dtype)
    _check(got, jref.flash_attention_ref(jq, jk, jv, causal=True), dtype)


@pytest.mark.parametrize("d", [24, 37, 48, 80, 96, 128])
def test_flash_attention_head_dims(d):
    """Head dims the kernel takes as they are (48, 80: h2o-danube-1.8b's,
    96, 128: mixtral-8x7b's) or zero-padded (24: nemo-smoke's; 37, odd),
    fp32, under a window shorter than Skv, at a ragged Sq: the plain
    version against the Pallas kernel in interpret mode and the JAX
    reference."""
    (jq, jk, jv), (q, k, v) = _inputs(d, 1, 4, 2, 70, 70, d, "float32")
    got = ops.flash_attention(q, k, v, causal=True, window=50)
    assert got.shape == (1, 4, 70, d)
    _check(got, jops.flash_attention(jq, jk, jv, causal=True, window=50,
                                     bq=64, bk=64), "float32")
    _check(got, jref.flash_attention_ref(jq, jk, jv, causal=True,
                                         window=50), "float32")


@pytest.mark.parametrize("window", [32, 128, None])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_masks(window, causal):
    (jq, jk, jv), (q, k, v) = _inputs(1, 1, 2, 2, 256, 256, 64, "float32")
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    _check(got, jops.flash_attention(jq, jk, jv, causal=causal,
                                     window=window, bq=64, bk=64),
           "float32")
    _check(got, jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                         window=window), "float32")


@pytest.mark.parametrize("window", [None, 48])
def test_flash_attention_q_offset(window):
    """Chunked prefill: q rows are a suffix of the kv range."""
    (jq, jk, jv), (q, k, v) = _inputs(2, 1, 2, 2, 64, 256, 64, "float32")
    got = ops.flash_attention(q, k, v, causal=True, q_offset=256 - 64,
                              window=window)
    _check(got, jops.flash_attention(jq, jk, jv, causal=True,
                                     q_offset=256 - 64, window=window,
                                     bq=64, bk=64), "float32")
    assert torch.equal(got, ops.flash_attention(q, k, v, causal=True,
                                                window=window))


def test_flash_attention_scale_and_plain_version():
    (jq, jk, jv), (q, k, v) = _inputs(3, 2, 4, 2, 40, 40, 32, "float32")
    got = ops.flash_attention(q, k, v, causal=False, scale=0.3)
    _check(got, jref.flash_attention_ref(jq, jk, jv, causal=False,
                                         scale=0.3), "float32")
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=False,
                                                    scale=0.3))
    assert torch.equal(ops.flash_attention(q, k, v, use_kernels=False),
                       ref.flash_attention_ref(q, k, v))


def test_flash_attention_kernel_refuses_what_it_does_not_take():
    q = torch.zeros(1, 4, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.flash_attention(q, k, k, use_kernels=True)
    with pytest.raises(ValueError, match="CUDA"):
        KF.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="backward"):
        KF.flash_attention(q.requires_grad_(), k, k)
    q = q.detach()
    with pytest.raises(ValueError, match="head dim 0"):
        KF.flash_attention(torch.zeros(1, 4, 8, 0),
                           torch.zeros(1, 2, 8, 0),
                           torch.zeros(1, 2, 8, 0))
    with pytest.raises(ValueError, match="not supported"):
        KF.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="multiple"):
        KF.flash_attention(torch.zeros(1, 3, 8, 64), k, k)
    with pytest.raises(ValueError, match="contiguous"):
        KF.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, k)
    with pytest.raises(ValueError, match="must be torch.float32"):
        KF.flash_attention(q, k.bfloat16(), k)
    assert KF.flash_attention.launches == 0


@pytest.mark.parametrize("d", [24, 37, 200, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padding_the_head_dim_is_exact(d, dtype):
    """The wrapper's padding, on the plain version: q, k and v with zero
    columns up to the next instantiated head dim (above 256 the next
    multiple of 16), at the original D's scale, sliced back, give the
    unpadded call's output bit for bit (the zero columns add exact zeros
    to every score)."""
    _, (q, k, v) = _inputs(d, 2, 4, 2, 70, 90, d, dtype)
    dp = KF.padded_dim(d)
    assert dp == {24: 32, 37: 48, 200: 256, 300: 304}[d]
    for kw in (dict(causal=True), dict(causal=False, window=20),
               dict(causal=True, q_offset=5, window=30)):
        padded = [KF.pad_head_dim(x, dp) for x in (q, k, v)]
        assert all(x.shape[-1] == dp and not x[..., d:].any()
                   for x in padded)
        got = ref.flash_attention_ref(*padded, scale=d ** -0.5, **kw)
        assert torch.equal(got[..., :d], ref.flash_attention_ref(q, k, v,
                                                                 **kw))


def test_meta_refuses_what_the_card_refuses():
    """The dry trace's flash call applies the wrapper's shape rules: a
    head dim of 0 both refuse alike; 24, 136, 256 and 320 both take (the
    card's rules, ``check_shapes``, pass; on the CPU the kernel then
    refuses the tensors for lying there)."""
    def args(d, device):
        return (torch.zeros(1, 4, 8, d, device=device),
                torch.zeros(1, 2, 8, d, device=device),
                torch.zeros(1, 2, 8, d, device=device))
    for call in (lambda d: KF.flash_attention(*args(d, "cpu")),
                 lambda d: KF.meta(*args(d, "meta"))):
        with pytest.raises(ValueError, match="head dim 0 not supported"):
            call(0)
    for d in (24, 136, 256, 320):
        KF.check_shapes(*args(d, "cpu"))
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            KF.flash_attention(*args(d, "cpu"))
    with Trace():
        for d in (24, 136, 256, 320):
            assert KF.meta(*args(d, "meta")).shape == (1, 4, 8, d)
        with pytest.raises(ValueError, match="multiple"):
            KF.meta(torch.zeros(1, 3, 8, 64, device="meta"),
                    *args(64, "meta")[1:])


def test_dry_trace_records_the_flash_call_at_head_dim_80():
    """``ops.flash_attention`` on ``meta`` tensors under a dry trace (the
    dry run's view of the card) records one kernel call at D 80, h2o-
    danube-1.8b's, with its ``work``: the windowed pairs, two products of
    2·D operations each a query head."""
    b, hq, hkv, s, d, w = 2, 4, 2, 96, 80, 40
    q = torch.empty((b, hq, s, d), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((b, hkv, s, d), dtype=torch.bfloat16, device="meta")
    art = trace(lambda q_, k_, v_: ops.flash_attention(
        q_, k_, v_, causal=True, window=w), q, kv, kv)
    assert art.profile.kernel_calls() == {"flash_attention": 1}
    _, nbytes, nops = art.profile.kernels["flash_attention"]
    pairs = sum(min(i + 1, w) for i in range(s))
    assert (nbytes, nops) == KF.work(q.shape, kv.shape, 2, window=w)
    assert nops == 4 * b * hq * pairs * d
    assert nbytes == 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    assert KF.work((1, 1, 8, 24), (1, 1, 8, 24), 4)[0] == 4 * 4 * 8 * 32


@pytest.mark.parametrize("d", [192, 256, 320])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dims_above_128(d, dtype):
    """Head dims the kernel takes above 128 (192 and 256 as they are, 320
    with O's columns split over the grid; Gemma-2-9B's is 256), GQA
    group 2, causal under a window and not: the plain version against the
    Pallas kernel in interpret mode and the JAX reference."""
    (jq, jk, jv), (q, k, v) = _inputs(d, 1, 4, 2, 72, 100, d, dtype)
    for kw in (dict(causal=True, window=48), dict(causal=False)):
        got = ops.flash_attention(q, k, v, **kw)
        assert got.shape == (1, 4, 72, d)
        _check(got, jops.flash_attention(jq, jk, jv, bq=64, bk=64, **kw),
               dtype)
        _check(got, jref.flash_attention_ref(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("d,dp", [(1, 16), (129, 192), (192, 192),
                                  (193, 256), (256, 256), (257, 272),
                                  (320, 320), (511, 512), (1000, 1008)])
def test_padded_dim_has_no_upper_end(d, dp):
    """Every head dim runs: up to 256 at the next instantiated one, above
    at the next multiple of 16 (the column split)."""
    assert KF.padded_dim(d) == dp


def test_dry_trace_records_the_flash_call_at_head_dim_256():
    """A dry trace records one flash call at Gemma-2-9B's shapes cut to
    size (16 query heads over 8, D 256, a window), with its ``work`` at D
    256."""
    b, hq, hkv, s, d, w = 1, 16, 8, 80, 256, 32
    q = torch.empty((b, hq, s, d), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((b, hkv, s, d), dtype=torch.bfloat16, device="meta")
    art = trace(lambda q_, k_, v_: ops.flash_attention(
        q_, k_, v_, causal=True, window=w), q, kv, kv)
    assert art.profile.kernel_calls() == {"flash_attention": 1}
    _, nbytes, nops = art.profile.kernels["flash_attention"]
    pairs = sum(min(i + 1, w) for i in range(s))
    assert (nbytes, nops) == KF.work(q.shape, kv.shape, 2, window=w)
    assert nops == 4 * b * hq * pairs * d
    assert nbytes == 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)


def _emulate_bf16_kernel(q, k, v, *, scale_err=1.0, drop_tile=None):
    """A plain emulation of the bf16 CUDA kernel's arithmetic (causal,
    q_offset = Skv - Sq): fp32 scores, scaled (times log2 e) in fp32; the
    online softmax over 64-key tiles in exp2; P rounded to bf16 before the
    P·V product, whose sums are fp32; l summed from the fp32 P; the output
    rounded to bf16 once.  ``scale_err`` and ``drop_tile`` plant faults."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(hq // hkv, 1)
    vf = v.float().repeat_interleave(hq // hkv, 1)
    sl2 = d ** -0.5 * scale_err * math.log2(math.e)
    qpos = torch.arange(sq)[:, None] + (skv - sq)
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    for t in range(0, skv, 64):
        if drop_tile == t // 64:
            continue
        s = (q.float() @ kf[:, :, t:t + 64].transpose(-1, -2)) * sl2
        s = s.masked_fill(torch.arange(t, min(t + 64, skv))[None] > qpos,
                          -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, t:t + 64]
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def _bf16_randn(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).bfloat16()


def test_flash_bf16_gate_holds_for_the_kernels_arithmetic():
    """The bf16 gate of the card tests and chip_smoke.py, |o - o64| <=
    2**-7 (|o64| + P64·|V| / l64) + 1e-5, holds for the kernel's
    arithmetic (P rounded to bf16 before P·V) with room to spare, and for
    the plain version."""
    q, k, v = (_bf16_randn(s, (1, 8, 1024, 64)) for s in (1, 2, 3))
    got = ref.flash_bf16_gate(_emulate_bf16_kernel(q, k, v), q, k, v)
    assert got <= 0.5, got
    assert ref.flash_bf16_gate(ref.flash_attention_ref(q, k, v), q, k,
                               v) <= 0.5


@pytest.mark.parametrize("fault", [dict(drop_tile=0), dict(drop_tile=16),
                                   dict(drop_tile=31), dict(scale_err=1.01),
                                   dict(scale_err=0.99)])
def test_flash_bf16_gate_rejects_a_faulty_result(fault):
    """The gate rejects a result that drops one 64-key tile at Skv 2048
    (the first, a middle and the last) or computes with a 1% wrong
    scale."""
    q, k, v = (_bf16_randn(s, (1, 2, 2048, 64)) for s in (4, 5, 6))
    assert ref.flash_bf16_gate(_emulate_bf16_kernel(q, k, v, **fault), q, k,
                               v) > 1.2
