"""Parity of the plain version of the port's ``segment_reduce`` kernel
(``repro_torch.kernels.ref.segment_reduce_ref``) and of its dispatch with
the JAX package's Pallas kernel, run in interpret mode as
``tests/test_kernels.py`` runs it, and with its ``ref`` oracle; including
uint32 wraparound.  The CUDA kernel runs only on the card
(``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, u32
from repro.core import pipeline as JP
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import pipeline as TP
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _inputs(t, seed, p_first=0.6):
    rng = np.random.default_rng(seed)
    w_lo = rng.integers(0, 2**32, t, dtype=np.uint64).astype(np.uint32)
    w_hi = rng.integers(0, 2**32, t, dtype=np.uint64).astype(np.uint32)
    first = rng.random(t) < p_first
    return w_lo, w_hi, first


@pytest.mark.parametrize("t,bt", [(1, 8), (8, 8), (40, 16), (100, 32),
                                  (1024, 256), (5000, 1024)])
def test_segment_reduce_plain_matches_pallas(t, bt):
    w_lo, w_hi, first = _inputs(t, seed=9 + t)
    got = tref.segment_reduce_ref(u32(w_lo), u32(w_hi),
                                  torch.from_numpy(first))
    jargs = (jnp.asarray(w_lo), jnp.asarray(w_hi), jnp.asarray(first))
    pallas = jops.segment_reduce(*jargs, bt=bt, use_pallas=True)
    oracle = jref.segment_reduce_ref(*jargs)
    for g, p, o, what in zip(got, pallas, oracle, ("lo", "hi", "cnt")):
        assert_same(g, p, f"pallas {what}")
        assert_same(g, o, f"ref {what}")
    disp = tops.segment_reduce(u32(w_lo), u32(w_hi), torch.from_numpy(first))
    for g, d in zip(got, disp):
        assert torch.equal(g, d)


@pytest.mark.parametrize("first_dtype", [torch.bool, torch.int32])
def test_segment_reduce_uint32_wraparound(first_dtype):
    """Prefix sums wrap mod 2**32 exactly (range differences of the mining
    signatures rely on modular arithmetic)."""
    t = 4096
    w = torch.full((t,), -1, dtype=torch.int32)        # 0xFFFFFFFF
    f = torch.ones((t,), dtype=first_dtype)
    lo, hi, cnt = tops.segment_reduce(w, w, f)
    want = np.cumsum(np.full(t, 0xFFFFFFFF, np.uint64)).astype(np.uint32)
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(cnt.numpy(), np.arange(1, t + 1))
    jlo, _, jcnt = jops.segment_reduce(
        jnp.full((t,), 0xFFFFFFFF, jnp.uint32),
        jnp.full((t,), 0xFFFFFFFF, jnp.uint32), jnp.ones((t,), bool),
        bt=1024, use_pallas=True)
    assert_same(lo, jlo, "pallas wraparound")
    assert_same(cnt, jcnt, "pallas count")


@pytest.mark.parametrize("t", [1, 37, 3000])
def test_masked_prefix_matches_jax(t):
    w_lo, w_hi, first = _inputs(t, seed=t, p_first=0.3)
    got = TP.masked_prefix(u32(w_lo), u32(w_hi), torch.from_numpy(first))
    want = JP.masked_prefix(jnp.asarray(w_lo), jnp.asarray(w_hi),
                            jnp.asarray(first), use_pallas=True)
    for g, w in zip(got, want):
        assert g.shape == (t + 1,)
        assert_same(g, w, "masked_prefix")


def test_segment_reduce_use_kernels_on_cpu():
    w_lo, w_hi, first = _inputs(64, seed=1)
    args = (u32(w_lo), u32(w_hi), torch.from_numpy(first))
    plain = tops.segment_reduce(*args, use_kernels=False)
    for a, b in zip(plain, tref.segment_reduce_ref(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="use_kernels=True needs CUDA"):
        tops.segment_reduce(*args, use_kernels=True)
