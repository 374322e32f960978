"""Parity of the plain version of the port's ``segment_reduce`` kernel
(``repro_torch.kernels.ref.segment_reduce_ref``), of the emulation of the
CUDA sweep's tile plan (``ref.segment_reduce_tiled``) and of the dispatch
(the inclusive and the (T + 1) entries) with the JAX package's Pallas
kernel, run in interpret mode as ``tests/test_kernels.py`` runs it, and
with its ``ref`` oracle; including uint32 wraparound.  The CUDA kernel
runs only on the card (``tests/test_torch_cuda.py``)."""
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
from repro_torch.kernels import segment_reduce as TKS


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


_TILE, _ITEMS = TKS.TILE, TKS.ITEMS


@pytest.mark.parametrize("t,tile,items,lag", [
    (1, None, None, 0), (_TILE - 1, None, None, 0), (_TILE, None, None, 0),
    (_TILE + 1, None, None, 1), (3 * _TILE + 5, None, None, 2),
    (1, 128, 4, 0), (127, 128, 4, 0), (128, 128, 4, 3), (129, 128, 4, 1),
    (1000, 128, 4, 5), (1000, 256, 8, 100), (3000, 512, 16, 0)])
def test_segment_reduce_tiled_matches_pallas_and_plain(t, tile, items, lag):
    """The CUDA sweep's decomposition (chunks of 4 a lane, warp and tile
    scans, per-lane status words walked back in claim order with ``lag``
    predecessors still AGGREGATE, the ragged last tile and element T) in
    its exclusive (T + 1) layout: element 0 is 0, elements 1..T are the
    plain inclusive sums and the Pallas kernel's in interpret mode."""
    w_lo, w_hi, first = _inputs(t, seed=t + lag, p_first=0.5)
    got = tref.segment_reduce_tiled(u32(w_lo), u32(w_hi),
                                    torch.from_numpy(first), tile, items, lag)
    plain = tref.segment_reduce_ref(u32(w_lo), u32(w_hi),
                                    torch.from_numpy(first))
    pallas = jops.segment_reduce(jnp.asarray(w_lo), jnp.asarray(w_hi),
                                 jnp.asarray(first), bt=128, use_pallas=True)
    for g, pl, pa, what in zip(got, plain, pallas, ("lo", "hi", "cnt")):
        assert g.shape == (t + 1,) and g.dtype == torch.int32
        assert int(g[0]) == 0
        assert torch.equal(g[1:], pl), what
        assert_same(g[1:], pa, f"pallas {what}")


@pytest.mark.parametrize("tile,items", [(128, 4), (None, None)])
def test_segment_reduce_tiled_wraps_mod_2_32(tile, items):
    """0xFFFFFFFF weights over many tiles wrap mod 2**32 in the emulation
    as in the Pallas kernel."""
    t = 5000
    w = np.full(t, 0xFFFFFFFF, np.uint32)
    f = np.ones(t, bool)
    got = tref.segment_reduce_tiled(u32(w), u32(w), torch.from_numpy(f),
                                    tile, items, lag=3)
    want = np.concatenate([np.zeros(1, np.uint64),
                           np.cumsum(np.full(t, 0xFFFFFFFF, np.uint64))])
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  want.astype(np.uint32))
    pallas = jops.segment_reduce(jnp.asarray(w), jnp.asarray(w),
                                 jnp.asarray(f), bt=1000, use_pallas=True)
    assert_same(got[1][1:], pallas[1], "pallas hi")
    assert_same(got[2][1:], pallas[2], "pallas count")


@pytest.mark.parametrize("t", [1, 37, 4097])
def test_segment_reduce_exclusive_matches_jax_masked_prefix(t):
    """The (T + 1) entry of the dispatch and ``masked_prefix`` (which
    takes it) equal ``repro.core.pipeline.masked_prefix``."""
    w_lo, w_hi, first = _inputs(t, seed=3 * t, p_first=0.4)
    args = (u32(w_lo), u32(w_hi), torch.from_numpy(first))
    want = JP.masked_prefix(jnp.asarray(w_lo), jnp.asarray(w_hi),
                            jnp.asarray(first), use_pallas=True)
    for got in (tops.segment_reduce_exclusive(*args),
                TP.masked_prefix(*args)):
        for g, w in zip(got, want):
            assert g.shape == (t + 1,)
            assert_same(g, w, "exclusive")


def test_segment_reduce_sweep_constants_match_the_kernel_source():
    """The tile plan's constants are the ones written in
    ``csrc/segment_reduce.cu`` (on the card they are also read from the
    built kernel at load), and ``plan`` follows them."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "segment_reduce.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (const("TPB"), const("ITEMS"), const("LANES"),
            const("LOOKBACK")) == (TKS.THREADS, TKS.ITEMS, TKS.LANES,
                                   TKS.LOOKBACK)
    assert "constexpr int TILE = TPB * ITEMS;" in src
    assert TKS.TILE == TKS.THREADS * TKS.ITEMS and TKS.ITEMS % 4 == 0
    assert TKS.LOOKBACK % 32 == 0
    for n, aligned in ((1, True), (TKS.TILE, False), (TKS.TILE + 1, True),
                       (816_197, True)):
        p = TKS.plan(n, aligned)
        assert p.tiles == -(-n // TKS.TILE)
        assert p.path == ("vector" if aligned else "scalar")


def test_segment_reduce_kernel_takes_cuda_tensors_only():
    w_lo, w_hi, first = _inputs(16, seed=2)
    args = (u32(w_lo), u32(w_hi), torch.from_numpy(first))
    with pytest.raises(ValueError, match="CUDA"):
        TKS.segment_reduce_exclusive(*args)
    with pytest.raises(ValueError, match="use_kernels=True"):
        tops.segment_reduce_exclusive(*args, use_kernels=True)
    assert TKS.segment_reduce.launches == 0
