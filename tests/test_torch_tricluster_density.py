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
from repro_torch.kernels import tricluster_density as KTD

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


# The CUDA kernel's decomposition (``kernels/tricluster_density.Plan`` and
# its emulation ``ref.tricluster_density_tiled``), held against the plain
# version and the Pallas kernel: ragged M (M % 32 != 0, M % 16 != 0,
# M < 32), G·B off the 128-column tile and B not dividing 128, B above the
# tile (its b range wraps), T off the 128-row tile and T = 1, K loops of 1,
# 2 and STAGES + 1 chunks of 128 bytes, and more t-tiles than one raster
# group.
RAGGED_SHAPES = [(9, 50, 4, 40), (5, 48, 3, 20), (6, 20, 7, 10),
                 (37, 70, 3, 130), (20, 33, 7, 129), (3, 40, 150, 17),
                 (11, 64, 5, 1), (11, 128, 5, 300), (4, 200, 3, 9),
                 (4, 512, 3, 9), (2, 16, 2, 2100)]


@pytest.mark.parametrize("g,m,b,t", SHAPES + RAGGED_SHAPES)
def test_tricluster_density_tiled_matches_plain_and_pallas(g, m, b, t):
    arrs = _inputs(g, m, b, t, seed=g * m + b + t)
    got = tref.tricluster_density_tiled(*(torch.from_numpy(a.astype(np.uint8))
                                          for a in arrs))
    assert got.dtype == torch.float32 and got.shape == (t,)
    assert torch.equal(got, tref.tricluster_density_ref(
        *(torch.from_numpy(a).to(torch.bool) for a in arrs)))
    assert_same(got, jops.tricluster_density(
        *(jnp.asarray(a, jnp.float32) for a in arrs)), "pallas")


def test_tricluster_density_tiled_all_ones_just_under_2_24():
    """All ones at G, M, B = 255, 256, 257: each numerator is G·M·B =
    16,776,960, just under 2**24, exactly."""
    g, m, b, t = 255, 256, 257, 3
    tensor = torch.ones((g, m, b), dtype=torch.bool)
    x, y, z = (torch.ones((t, n), dtype=torch.bool) for n in (g, m, b))
    want = torch.full((t,), 16_776_960.0)
    assert g * m * b == 16_776_960 < 2**24
    assert torch.equal(tref.tricluster_density_tiled(tensor, x, y, z), want)
    assert torch.equal(tref.tricluster_density_ref(tensor, x, y, z), want)
    assert_same(want, jops.tricluster_density(
        *(jnp.asarray(a.numpy(), jnp.float32) for a in (tensor, x, y, z))),
        "pallas")


def test_plan_at_the_movielens_shape():
    """The decomposition at the dense path's MovieLens-1M shape."""
    assert KTD.plan(9, 4, 512, 3).chunks == KTD.STAGES + 1
    p = KTD.plan(356_877, 6040, 3952, 5)
    assert (p.n, p.kp, p.n_pad) == (30_200, 3968, 30_208)
    assert (p.tiles_t, p.tiles_n, p.blocks, p.chunks) == (2789, 236,
                                                         658_204, 31)
    assert p.image_bytes == 30_208 * 3968 == 119_865_344
    assert p.scratch_words == 119_865_344 // 4 + 2 * 356_877
    assert p.column(0) == (0, 0) and p.column(127) == (25, 2)
    assert p.column(p.n - 1) == (6039, 4)


@pytest.mark.parametrize("tiles_t,tiles_n", [(1, 1), (16, 3), (17, 5),
                                             (40, 2), (33, 1)])
def test_plan_raster_covers_every_tile_once_in_groups(tiles_t, tiles_n):
    p = KTD.plan(tiles_t * KTD.TILE_T - 5, tiles_n * KTD.TILE_N, 1, 1)
    assert (p.tiles_t, p.tiles_n) == (tiles_t, tiles_n)
    seen = [p.tile(pid) for pid in range(p.blocks)]
    assert sorted(seen) == [(i, j) for i in range(tiles_t)
                            for j in range(tiles_n)]
    for pid, (tt, nt) in enumerate(seen):
        # a group's blocks are contiguous, its n-tiles in order
        group = pid // (KTD.GROUP_T * tiles_n)
        assert tt // KTD.GROUP_T == group
        assert nt == (pid - group * KTD.GROUP_T * tiles_n) // min(
            KTD.GROUP_T, tiles_t - group * KTD.GROUP_T)


@pytest.mark.parametrize("g,b", [(6040, 5), (100, 1), (9, 127), (5, 128),
                                 (4, 129), (3, 300), (2, 1000), (37, 3)])
def test_plan_columns_in_the_tiled_epilogue(g, b):
    """Every column n < G·B is one (g, b) of the tensor, in order; the
    emulation's epilogue weighs it by X[t,g]·Z[t,b] across n-tiles whose
    b range wraps (B > 128) or splits a g, and equals the plain version."""
    p = KTD.plan(5, g, 3, b)
    assert [p.column(n) for n in range(p.n)] == [
        (gg, bb) for gg in range(g) for bb in range(b)]
    arrs = _inputs(g, 3, b, 5, seed=g + b)
    args = [torch.from_numpy(a.astype(np.uint8)) for a in arrs]
    assert torch.equal(tref.tricluster_density_tiled(*args),
                       tref.tricluster_density_ref(*args))
