"""Parity of the port's ``kernels.ops.flash_attention`` with the JAX
package on the CPU.  On CPU tensors the op runs its plain version
(``kernels.ref.flash_attention_ref``); it is held against the JAX op —
the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it
— and against the JAX reference, on the same inputs made from a numpy
seed, at the tolerances of ``tests/test_kernels.py`` (fp32 2e-5, bf16
2e-2).  The CUDA kernel itself is held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``); here its wrapper's
argument checks run."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref

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
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_shapes(b, hq, hkv, sq, skv, d, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(sq + d, b, hq, hkv, sq, skv, d, dtype)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.shape == (b, hq, sq, d)
    _check(got, jops.flash_attention(jq, jk, jv, causal=True, bq=64, bk=64),
           dtype)
    _check(got, jref.flash_attention_ref(jq, jk, jv, causal=True), dtype)


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
    with pytest.raises(ValueError, match="head dim 24"):
        KF.flash_attention(torch.zeros(1, 4, 8, 24), torch.zeros(1, 2, 8, 24),
                           torch.zeros(1, 2, 8, 24))
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
