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
    with pytest.raises(ValueError, match="head dim 24"):
        KD.decode_attention(torch.zeros(1, 4, 24), torch.zeros(1, 2, 8, 24),
                            torch.zeros(1, 2, 8, 24))
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
    assert KD.HEAD_DIMS == (16, 32, 64, 80, 128)
    assert KD.decode_attention.launches == 0
