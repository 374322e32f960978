"""Parity of the plain version of the port's ``tricluster_density`` kernel
(``repro_torch.kernels.ref.tricluster_density_ref``) and of its dispatch
(``ops.tricluster_density`` / ``ops.exact_density``) with the JAX
package's Pallas kernel, run as ``tests/test_kernels.py`` runs it, with its
``ref`` oracle and with a literal triple-loop box count.  Numerators are
integer-valued float32 and must be bit-equal.  The CUDA kernel runs only
on the card (``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SHAPES = [(8, 16, 16, 8), (16, 8, 32, 128), (7, 5, 9, 3)]


def _inputs(g, m, b, t, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2, s) for s in ((g, m, b), (t, g), (t, m),
                                            (t, b))]


@pytest.mark.parametrize("g,m,b,t", SHAPES)
def test_tricluster_density_plain_matches_pallas(g, m, b, t):
    arrs = _inputs(g, m, b, t, seed=7)
    jargs = [jnp.asarray(a, jnp.float32) for a in arrs]
    got = tref.tricluster_density_ref(*(torch.from_numpy(a.astype(np.uint8))
                                        for a in arrs))
    assert got.dtype == torch.float32 and got.shape == (t,)
    assert_same(got, jops.tricluster_density(*jargs), "pallas")
    assert_same(got, jref.tricluster_density_ref(*jargs), "ref")
    disp = tops.tricluster_density(*(torch.from_numpy(a).to(torch.bool)
                                     for a in arrs))
    assert torch.equal(got, disp)
    dens = tops.exact_density(*(torch.from_numpy(a).to(torch.float32)
                                for a in arrs))
    assert_same(dens, jops.exact_density(*jargs), "exact_density")


def test_tricluster_density_against_brute_force():
    """The numerator equals a literal triple-loop box count."""
    g, m, b, t = 6, 7, 8, 4
    tensor, x, y, z = _inputs(g, m, b, t, seed=8)
    want = np.zeros(t, np.float32)
    for ti in range(t):
        for gi in range(g):
            for mi in range(m):
                for bi in range(b):
                    want[ti] += (x[ti, gi] * y[ti, mi] * z[ti, bi]
                                 * tensor[gi, mi, bi])
    got = tops.tricluster_density(*(torch.from_numpy(a) for a in
                                    (tensor, x, y, z)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk_elems", [1, 50, 400])
def test_tricluster_density_chunks_agree(chunk_elems):
    """Chunking over T and G does not change the numerators."""
    arrs = [torch.from_numpy(a) for a in _inputs(13, 11, 6, 29, seed=9)]
    assert torch.equal(tref.tricluster_density_ref(*arrs,
                                                   chunk_elems=chunk_elems),
                       tref.tricluster_density_ref(*arrs))


def test_tricluster_density_empty_and_use_kernels():
    tensor = torch.ones((3, 4, 5), dtype=torch.bool)
    x = torch.zeros((0, 3), dtype=torch.bool)
    y = torch.zeros((0, 4), dtype=torch.bool)
    z = torch.zeros((0, 5), dtype=torch.bool)
    assert tops.tricluster_density(tensor, x, y, z).shape == (0,)
    full = [torch.ones((2, n), dtype=torch.bool) for n in (3, 4, 5)]
    np.testing.assert_array_equal(
        tops.exact_density(tensor, *full, use_kernels=False).numpy(),
        np.ones(2, np.float32))
    with pytest.raises(ValueError, match="use_kernels=True needs CUDA"):
        tops.tricluster_density(tensor, *full, use_kernels=True)
