"""Parity of the plain version of the port's ``signature`` kernel
(``repro_torch.kernels.ref.signature_ref``) and of its dispatch
(``ops.set_signature``) with the JAX package's Pallas kernel, run as
``tests/test_kernels.py`` runs it, and with its ``ref`` oracle: at the JAX
tests' shapes, for every mask dtype, order independence and uint32
wraparound.  The CUDA kernel runs only on the card
(``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, u32
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SHAPES = [(8, 128), (16, 512), (256, 1024), (3, 77)]


@pytest.mark.parametrize("t,e", SHAPES)
def test_signature_plain_matches_pallas(t, e):
    rng = np.random.default_rng(5)
    mask = rng.integers(0, 2, (t, e)).astype(np.uint32)
    r = rng.integers(1, 2**32, e, dtype=np.uint32)
    got = tref.signature_ref(torch.from_numpy(mask.astype(np.uint8)), u32(r))
    assert got.dtype == torch.int32 and got.shape == (t,)
    assert_same(got, jops.set_signature(jnp.asarray(mask), jnp.asarray(r)),
                "pallas")
    assert_same(got, jref.signature_ref(jnp.asarray(mask), jnp.asarray(r)),
                "ref")
    assert torch.equal(got, tops.set_signature(torch.from_numpy(mask != 0),
                                               u32(r)))


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int32,
                                   torch.float32])
def test_signature_mask_dtypes(dtype):
    rng = np.random.default_rng(11)
    mask = rng.integers(0, 2, (37, 203))
    r = rng.integers(1, 2**32, 203, dtype=np.uint32)
    want = jref.signature_ref(jnp.asarray(mask, jnp.uint32), jnp.asarray(r))
    got = tops.set_signature(torch.from_numpy(mask).to(dtype), u32(r))
    assert_same(got, want, str(dtype))


def test_signature_order_independent():
    rng = np.random.default_rng(6)
    e = 128
    r = u32(rng.integers(1, 2**32, e, dtype=np.uint32))
    m1 = np.zeros((8, e), np.uint8)
    m1[:, rng.choice(e, 20, replace=False)] = 1
    s1 = tops.set_signature(torch.from_numpy(m1), r)
    assert len(set(s1.tolist())) == 1            # identical sets hash equal
    perm = torch.from_numpy(rng.permutation(e))
    s2 = tops.set_signature(torch.from_numpy(m1)[:, perm], r[perm])
    assert torch.equal(s1, s2)                   # entity order is irrelevant


def test_signature_uint32_wraparound():
    """Sums of r near 2**32 wrap mod 2**32, as uint32 arithmetic does."""
    t, e = 5, 1000
    rng = np.random.default_rng(3)
    r = (2**32 - 1 - rng.integers(0, 8, e)).astype(np.uint32)
    mask = np.ones((t, e), np.uint8)
    mask[1, ::2] = 0
    mask[2] = 0
    want = (mask.astype(np.uint64) * r.astype(np.uint64)).sum(1) % 2**32
    got = tops.set_signature(torch.from_numpy(mask), u32(r))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.astype(np.uint32))
    assert_same(got, jops.set_signature(jnp.asarray(mask, jnp.uint32),
                                        jnp.asarray(r)), "pallas")


def test_signature_row_chunks_agree():
    """The plain version's row chunking does not change the result."""
    rng = np.random.default_rng(4)
    mask = torch.from_numpy(rng.integers(0, 2, (301, 77)).astype(np.uint8))
    r = u32(rng.integers(1, 2**32, 77, dtype=np.uint32))
    assert torch.equal(tref.signature_ref(mask, r, chunk_elems=100),
                       tref.signature_ref(mask, r))


def test_signature_use_kernels_on_cpu():
    mask = torch.ones((4, 9), dtype=torch.bool)
    r = torch.arange(9, dtype=torch.int32)
    assert torch.equal(tops.set_signature(mask, r, use_kernels=False),
                       torch.full((4,), 36, dtype=torch.int32))
    with pytest.raises(ValueError, match="use_kernels=True needs CUDA"):
        tops.set_signature(mask, r, use_kernels=True)
