"""Parity of the port's radix sort (``repro_torch.core.radix``) and of the
plain versions of its two kernels (``repro_torch.kernels.ref``) with the
JAX package: plans, digit extraction, the histogram and rank sweeps
against the Pallas kernels run in interpret mode (as
``tests/test_kernels.py`` runs them) and against their ``ref`` oracles,
the rank sweep's tile plan (``ref.radix_rank_tiled``) and the fused LSD
pass (``ref.radix_pass_ref``) against both, and the sort permutation
against numpy's stable argsort.  CUDA kernels run only on the card
(``tests/test_torch_cuda.py``)."""
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
from repro_torch.kernels import radix_sort as TK
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


_TILE = TK.RANK_TILE
_DIGITS = {
    "uniform": lambda rng, t: rng.integers(0, 256, t),
    "skew 90%": lambda rng, t: np.where(rng.random(t) < 0.9, 7,
                                        rng.integers(0, 256, t)),
    "all equal": lambda rng, t: np.full(t, 255),
}


def _digits_and_starts(kind, t, seed):
    dig = _DIGITS[kind](np.random.default_rng(seed), t).astype(np.uint32)
    hist = np.bincount(dig, minlength=256)
    starts = np.concatenate([[0], np.cumsum(hist)[:-1]]).astype(np.int32)
    return dig, starts


@pytest.mark.parametrize("t", [1, _TILE - 1, _TILE, _TILE + 1,
                               2 * _TILE - 1, 2 * _TILE + 1])
@pytest.mark.parametrize("kind", list(_DIGITS))
def test_radix_rank_tiled_matches_plain_and_pallas(t, kind):
    """The CUDA rank sweep's decomposition (per-tile counts, their
    exclusive prefix over the tiles, warp starts, in-warp ranks) at its
    own tile, on both sides of one and two tiles, equals the plain ranks
    and the Pallas kernel's in interpret mode."""
    dig, starts = _digits_and_starts(kind, t, t)
    d32, s32 = torch.from_numpy(dig.astype(np.int32)), torch.from_numpy(starts)
    got = tref.radix_rank_tiled(d32, s32)
    assert got.dtype == torch.int32
    assert torch.equal(got, tref.radix_rank_ref(d32, s32))
    assert_same(got, jops.radix_rank(jnp.asarray(dig), jnp.asarray(starts),
                                     bt=1024, use_pallas=True), "pallas")


@pytest.mark.parametrize("tile,warps", [(64, 8), (96, 3), (32, 1)])
@pytest.mark.parametrize("kind", list(_DIGITS))
def test_radix_rank_tiled_at_small_tiles(tile, warps, kind):
    """Many tiles and warps at a small T: the same ranks as the plain
    version and the JAX reference."""
    dig, starts = _digits_and_starts(kind, 1000, tile + warps)
    d32, s32 = torch.from_numpy(dig.astype(np.int32)), torch.from_numpy(starts)
    got = tref.radix_rank_tiled(d32, s32, tile=tile, warps=warps)
    assert torch.equal(got, tref.radix_rank_ref(d32, s32))
    assert_same(got, jref.radix_rank_ref(jnp.asarray(dig),
                                         jnp.asarray(starts)), "ref")


def _old_pass(words, perm, shift, width, starts):
    """The per-pass sequence the fused pass replaces: the digit of the
    original words gathered through the permutation, its ranks, and the
    permutation composed with their inverse."""
    dig = TR.extract_digit(words, shift, width)
    if perm is not None:
        dig = dig[perm]
    rank = tref.radix_rank_ref(dig, starts)
    iota = torch.arange(dig.shape[0], dtype=torch.int32)
    src = torch.empty_like(iota)
    src[rank.long()] = iota
    return src if perm is None else perm[src]


@pytest.mark.parametrize("t,live", [(1, 5), (300, 22), (2000, 31),
                                    (1500, 44), (1200, 64)])
def test_radix_pass_plain_matches_the_per_pass_sequence(t, live):
    """Pass after pass, the plain fused pass (digits of the words in the
    current order, words and payload moved to their ranks) keeps the
    permutation of the old sequence, and its words are the original
    words in that order."""
    keys = _keys(t, live, seed=t + live)
    words = [u32(w) for w in _words(keys, live)]
    plan = TR.plan_radix(live, t, digit_bits=8)
    hists = tref.radix_histogram_ref(words, plan.shifts, plan.widths)
    starts = torch.cumsum(hists, 1, dtype=torch.int32) - hists
    cur, perm, old = tuple(words), None, None
    for p, (shift, width) in enumerate(zip(plan.shifts, plan.widths)):
        old = _old_pass(words, old, shift, width, starts[p])
        cur, perm = tref.radix_pass_ref(cur, perm, shift, width, starts[p])
        assert perm.dtype == torch.int32 and torch.equal(perm, old), p
        for c, w in zip(cur, words):
            assert torch.equal(c, w[perm.long()]), p
        assert torch.equal(tops.radix_pass(cur, perm, shift, width,
                                           starts[p])[1],
                           tref.radix_pass_ref(cur, perm, shift, width,
                                               starts[p])[1])
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(keys, kind="stable"))
    sw, (sp,) = TR.sort_with_payload_radix(words, (-perm,), live)
    assert all(torch.equal(a, b) for a, b in zip(sw, cur))
    assert torch.equal(sp, -perm[perm.long()])


def test_rank_sweep_constants_match_the_kernel_source():
    """The tile plan's constants are the ones written in
    ``csrc/radix_sort.cu`` (on the card they are also read from the built
    kernel at load)."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "radix_sort.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert "constexpr int R_TPB = BUCKETS;" in src
    assert const("BUCKETS") == TR.HIST_BUCKETS == TK.RANK_THREADS
    assert TK.RANK_THREADS // 32 == TK.RANK_WARPS
    assert (32 * const("R_ITEMS") * TK.RANK_WARPS, const("LOOKBACK")) == (
        TK.RANK_TILE, TK.LOOKBACK)


@pytest.mark.parametrize("t", [1, 3, 4, 5, 4095, 4096, 4097,
                               TK.HIST_KEYS * TK.HIST_THREADS * 132 + 2,
                               816_197])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("sms", [132, 8])
def test_hist_plan(t, aligned, sms):
    """The histogram sweep's plan: a persistent grid of
    HIST_BLOCKS_PER_SM blocks an SM, fewer when the keys do not give each
    of their threads a vector; 16-byte loads on aligned words with the
    last T mod 4 keys by scalar loads, else scalar loads throughout."""
    p = TK.hist_plan(t, aligned, sms)
    vectors = -(-t // TK.HIST_KEYS)
    assert p.vectors == vectors
    assert p.blocks == max(1, min(sms * TK.HIST_BLOCKS_PER_SM,
                                  -(-vectors // TK.HIST_THREADS)))
    assert 1 <= p.blocks <= sms * TK.HIST_BLOCKS_PER_SM
    # every block has a share, and the shares cover the vectors
    per = -(-vectors // p.blocks)
    assert (p.blocks - 1) * per < vectors <= p.blocks * per
    if aligned:
        assert (p.path, p.tail) == ("vector", t % TK.HIST_KEYS)
    else:
        assert (p.path, p.tail) == ("scalar", t)
    if t == 816_197:
        assert p.blocks == sms * TK.HIST_BLOCKS_PER_SM


def _widths_plan(npass, nw):
    widths = [1 + (p * 3 + npass) % 8 for p in range(npass)]
    while sum(widths) > 32 * nw:
        widths = [max(1, w - 1) for w in widths]
    return [int(x) for x in np.cumsum([0] + widths[:-1])], widths


@pytest.mark.parametrize("npass", range(1, 9))
@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("kind", ["random", "all equal"])
def test_radix_histogram_warp_matches_plain_and_pallas(npass, nw, kind):
    """The emulation of the CUDA sweep's counting (its grid's shares, a
    warp's 32 lanes one key of a vector at a time, the lanes on one bucket
    added in one operation: peers by digit bits, the lowest adds their
    number) equals the plain histograms and the Pallas kernel's, 1-8
    passes of widths 1-8 on 1 and 2 words, 1 and 3 blocks."""
    t = 1000 + npass
    keys = _keys(t, 32 * nw, seed=npass * 2 + nw)
    if kind == "all equal":
        keys[:] = keys[-1]
    words = _words(keys, 32 * nw) if nw == 2 else [keys.astype(np.uint32)]
    tw = [u32(w) for w in words]
    shifts, widths = _widths_plan(npass, nw)
    want = tref.radix_histogram_ref(tw, shifts, widths)
    pallas = jops.radix_histogram([jnp.asarray(w) for w in words], shifts,
                                  widths, bt=256, use_pallas=True)
    for blocks in (1, 3):
        got, additions = tref.radix_histogram_warp(tw, shifts, widths,
                                                   blocks)
        assert torch.equal(got, want)
        assert_same(got, pallas, "pallas")
        assert 0 < additions <= t * npass
        if kind == "all equal":
            # one addition a warp, key slot and pass
            nvec = -(-t // TK.HIST_KEYS)
            per = -(-nvec // blocks)
            vec = np.arange(t) // TK.HIST_KEYS
            rows = (vec // per) * (-(-per // 32)) + vec % per // 32
            groups = np.unique(rows * TK.HIST_KEYS + np.arange(t)
                               % TK.HIST_KEYS).size
            assert additions == groups * npass


def test_histogram_sweep_constants_match_the_kernel_source():
    """The histogram plan's constants are the ones written in
    ``csrc/radix_sort.cu`` (on the card they are also read from the built
    kernel at load)."""
    import re
    from repro_torch.kernels import build
    src = (build.CSRC / "radix_sort.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (const("H_THREADS"), const("H_BLOCKS_PER_SM"), const("H_KEYS"),
            const("H_UNROLL"), const("H_COPIES"), const("MAX_PASS")) == (
        TK.HIST_THREADS, TK.HIST_BLOCKS_PER_SM, TK.HIST_KEYS,
        TK.HIST_UNROLL, TK.HIST_COPIES, 8)
    assert TK.HIST_KEYS * 4 == TK.VEC_BYTES      # one 16-byte load a word


def test_radix_histogram_kernel_takes_cuda_tensors_only():
    w = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TK.radix_histogram([w], [0], [8])
    with pytest.raises(ValueError, match="use_kernels=True"):
        tops.radix_histogram([w], [0], [8], use_kernels=True)
    assert TK.radix_histogram.launches == 0


def test_radix_pass_kernel_takes_cuda_tensors_only():
    w = torch.zeros(16, dtype=torch.int32)
    starts = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        TK.radix_pass([w], None, 0, 8, starts)
    with pytest.raises(ValueError, match="use_kernels=True"):
        tops.radix_pass([w], None, 0, 8, starts, use_kernels=True)
    assert TK.radix_rank.launches == 0


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
