"""Parity of the port's radix sort (``repro_torch.core.radix``) and of the
plain versions of its two kernels (``repro_torch.kernels.ref``) with the
JAX package: plans, digit extraction, the histogram and rank sweeps
against the Pallas kernels run in interpret mode (as
``tests/test_kernels.py`` runs them) and against their ``ref`` oracles,
and the sort permutation against numpy's stable argsort.  CUDA kernels
run only on the card (``tests/test_torch_cuda.py``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, u32
from repro.core import radix as JR
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import radix as TR
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _keys(t, live, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << min(live, 63), t, dtype=np.uint64)
    if live == 64:
        keys |= rng.integers(0, 2, t, dtype=np.uint64) << np.uint64(63)
    keys[: t // 4] = keys[0]                          # ties
    return keys


def _words(keys, live):
    if live > 32:
        return [(keys >> np.uint64(32)).astype(np.uint32),
                keys.astype(np.uint32)]
    return [keys.astype(np.uint32)]


@pytest.mark.parametrize("live", [1, 5, 8, 22, 31, 32, 44, 60, 64])
@pytest.mark.parametrize("t", [1, 100, 816_197])
@pytest.mark.parametrize("digit_bits", [None, 8])
def test_plan_radix(live, t, digit_bits):
    got = TR.plan_radix(live, t, digit_bits)
    want = JR.plan_radix(live, t, digit_bits)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.passes == want.passes
    assert TR.pos_bits(t) == JR.pos_bits(t)


@pytest.mark.parametrize("nw", [1, 2])
def test_extract_digit(nw):
    keys = _keys(300, 32 * nw, seed=nw)
    words = _words(keys, 32 * nw)
    tw = [u32(w) for w in words]
    jw = [jnp.asarray(w) for w in words]
    for shift in range(0, 32 * nw, 3):
        for width in (1, 5, 8, 13):
            if shift + width > 32 * nw:
                continue
            assert_same(TR.extract_digit(tw, shift, width).to(torch.int32),
                        np.asarray(JR.extract_digit(jw, shift, width))
                        .astype(np.int32), f"{shift}/{width}")


@pytest.mark.parametrize("t,bt,live", [(8, 8, 5), (100, 32, 22),
                                       (513, 128, 28), (1024, 256, 60),
                                       (2000, 512, 64)])
def test_radix_histogram_plain_matches_pallas(t, bt, live):
    keys = _keys(t, live, seed=t)
    words = _words(keys, live)
    plan = TR.plan_radix(live, t, digit_bits=8)
    got = tref.radix_histogram_ref([u32(w) for w in words], plan.shifts,
                                   plan.widths)
    jw = [jnp.asarray(w) for w in words]
    assert_same(got, jops.radix_histogram(jw, plan.shifts, plan.widths,
                                          bt=bt, use_pallas=True), "pallas")
    assert_same(got, jref.radix_histogram_ref(jw, plan.shifts, plan.widths),
                "ref")
    # the dispatch runs the plain version on CPU tensors
    assert torch.equal(tops.radix_histogram([u32(w) for w in words],
                                            plan.shifts, plan.widths), got)
    assert int(got.sum()) == t * plan.passes


@pytest.mark.parametrize("t,bt", [(8, 8), (100, 32), (513, 128),
                                  (2000, 512)])
@pytest.mark.parametrize("chunk", [7, 8192])
def test_radix_rank_plain_matches_pallas(t, bt, chunk):
    rng = np.random.default_rng(t + 1)
    dig = rng.integers(0, 256, t).astype(np.uint32)
    dig[: t // 3] = dig[0]                              # a heavy bucket
    hist = np.bincount(dig, minlength=256)
    starts = np.concatenate([[0], np.cumsum(hist)[:-1]]).astype(np.int32)
    got = tref.radix_rank_ref(torch.from_numpy(dig.astype(np.int32)),
                              torch.from_numpy(starts), chunk=chunk)
    jd, js = jnp.asarray(dig), jnp.asarray(starts)
    assert_same(got, jops.radix_rank(jd, js, bt=bt, use_pallas=True),
                "pallas")
    assert_same(got, jref.radix_rank_ref(jd, js), "ref")
    r = got.numpy()
    assert sorted(r.tolist()) == list(range(t))
    assert (dig[np.argsort(r)] == np.sort(dig, kind="stable")).all()


@pytest.mark.parametrize("t,live", [(1, 5), (64, 9), (777, 22), (2000, 31),
                                    (1500, 44), (1200, 64)])
def test_radix_sort_perm_is_stable_argsort(t, live):
    keys = _keys(t, live, seed=live)
    words = _words(keys, live)
    perm = TR.radix_sort_perm([u32(w) for w in words], live)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(keys, kind="stable"))
    jperm = JR.radix_sort_perm([jnp.asarray(w) for w in words], live)
    assert_same(perm, jperm, "jax radix_sort_perm")
    sw, (sp,) = TR.sort_with_payload_radix(
        [u32(w) for w in words], (torch.arange(t, dtype=torch.int32),), live)
    assert torch.equal(sp, perm)


@pytest.mark.parametrize("max_passes", [1, 2, 3])
def test_radix_sort_perm_max_passes(max_passes):
    """Truncated schedules count 8-bit histogram passes, as the JAX
    package's kernel formulation does."""
    keys = _keys(300, 30, seed=max_passes)
    words = _words(keys, 30)
    got = TR.radix_sort_perm([u32(w) for w in words], 30,
                             max_passes=max_passes)
    want = JR.radix_sort_perm([jnp.asarray(w) for w in words], 30,
                              use_pallas=True, max_passes=max_passes)
    assert_same(got, want, "truncated perm")


@pytest.mark.parametrize("live", [1, 16, 17, 40, 64])
def test_radix_argsort_host(live):
    keys = _keys(1000, live, seed=3)
    np.testing.assert_array_equal(TR.radix_argsort_host(keys, live),
                                  JR.radix_argsort_host(keys, live))


@pytest.mark.parametrize("t,budget", [(1, None), (10, 3), (10, 10),
                                      (10, 100), (7, 1)])
def test_plan_windows(t, budget):
    got, want = TR.plan_windows(t, budget), JR.plan_windows(t, budget)
    assert (got.t, got.budget, got.n_windows, got.bounds) == \
        (want.t, want.budget, want.n_windows, want.bounds)


def test_plan_windows_rejects_degenerate_budgets():
    for t, budget in ((0, None), (5, 0), (5, -1)):
        with pytest.raises(ValueError):
            TR.plan_windows(t, budget)
        with pytest.raises(ValueError):
            JR.plan_windows(t, budget)


def test_backend_resolution_matches():
    for sb in (None, "auto", "radix", "lax", "lexsort"):
        for packed in (None, True, False):
            for fits in (True, False):
                assert (TR.resolve_sort_backend(sb, packed, fits)
                        == JR.resolve_sort_backend(sb, packed, fits))
            for prune in (True, False):
                assert (TR.wants_value_pruning(prune, packed, sb)
                        == JR.wants_value_pruning(prune, packed, sb))
    with pytest.raises(ValueError):
        TR.resolve_sort_backend("bogus", None, True)
