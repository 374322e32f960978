"""Parity of the port's mining pipeline (``repro_torch.core``) with the JAX
package on the CPU: every ``PipelineResult`` leaf of batch prime and NOAC
mining, bit for bit, across the radix, lax and lexsort sort paths, with
value-lane pruning on and off, a forced fallback above 64 key bits, and
the JAX kernels in interpret mode; the registry's ``mine()`` cluster sets;
the hashing and segmentation primitives; and the CLI twin."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_results_identical, assert_same, u32
from repro.core import BatchMiner as JBatch
from repro.core import NOACMiner as JNOAC
from repro.core import mine as jmine
from repro.core import pipeline as JP
from repro.data import synthetic as JS
from repro.launch import tricluster as jcli
from repro_torch.core import BatchMiner, NOACMiner, available_engines, mine
from repro_torch.core import pipeline as TP
from repro_torch.data import synthetic as TS
from repro_torch.launch import tricluster as tcli

PRIME_CONTEXTS = {
    "imdb": lambda S: S.imdb_like(),
    "random3": lambda S: S.random_context((7, 6, 5), 64, seed=3),
    "random4": lambda S: S.random_context((5, 4, 3, 6), 200, seed=5),
    "bibsonomy_small": lambda S: S.bibsonomy_like(scale=0.002),
    "duplicates": lambda S: S.random_context((3, 3, 3), 100, seed=6),
}
NOAC_CONTEXTS = {
    "movielens": (lambda S: S.movielens_like(n_tuples=2000, seed=1), 1.0),
    "random_values": (lambda S: S.random_context((7, 6, 5), 150, seed=4,
                                                 values=True), 60.0),
    "frames": (lambda S: S.semantic_frames_like(n_tuples=800), 5.0),
}
BACKENDS = [None, "lax", "lexsort"]


def _same_context(name, table):
    """The same context from both packages' (identical) generators."""
    j, t = table[name](JS), table[name](TS)
    np.testing.assert_array_equal(j.tuples, t.tuples)
    if j.values is not None:
        np.testing.assert_array_equal(j.values, t.values)
    return j, t


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(PRIME_CONTEXTS))
def test_prime_pipeline_bit_identical(name, backend):
    jctx, tctx = _same_context(name, PRIME_CONTEXTS)
    want = JBatch(jctx.sizes, sort_backend=backend)(jctx.tuples)
    miner = BatchMiner(tctx.sizes, sort_backend=backend, device="cpu")
    assert miner.resolved_sort_backend == (backend or "radix")
    assert_results_identical(want, miner(tctx.tuples))


@pytest.mark.parametrize("backend,prune", [
    (b, p) for b in BACKENDS for p in (True, False)
    if not (b == "lexsort" and not p)])     # lexsort never prunes
@pytest.mark.parametrize("name", sorted(NOAC_CONTEXTS))
def test_noac_pipeline_bit_identical(name, backend, prune):
    make, delta = NOAC_CONTEXTS[name]
    jctx, tctx = make(JS).deduplicated(), make(TS).deduplicated()
    want = JNOAC(jctx.sizes, delta=delta, sort_backend=backend,
                 prune_values=prune)(jctx.tuples, jctx.values)
    got = NOACMiner(tctx.sizes, delta=delta, sort_backend=backend,
                    prune_values=prune, device="cpu")(tctx.tuples,
                                                      tctx.values)
    assert_results_identical(want, got)


def test_thresholds_bit_identical():
    ctx = TS.random_context((6, 5, 4), 120, seed=8, values=True)
    want = JBatch(ctx.sizes, theta=0.5)(ctx.tuples)
    got = BatchMiner(ctx.sizes, theta=0.5, device="cpu")(ctx.tuples)
    assert_results_identical(want, got)
    want = JNOAC(ctx.sizes, delta=100.0, rho_min=0.3, minsup=2)(
        ctx.tuples, ctx.values)
    got = NOACMiner(ctx.sizes, delta=100.0, rho_min=0.3, minsup=2,
                    device="cpu")(ctx.tuples, ctx.values)
    assert_results_identical(want, got)


def test_packed_false_is_the_lexsort_path():
    ctx = TS.random_context((7, 6, 5), 64, seed=2)
    miner = BatchMiner(ctx.sizes, packed=False, device="cpu")
    assert not miner.packed_active
    assert_results_identical(JBatch(ctx.sizes, packed=False)(ctx.tuples),
                             miner(ctx.tuples))


def test_over_64_bit_key_falls_back_to_lexsort():
    # 4 modes × 17 bits = 68 key bits: no packed path
    sizes = (1 << 17,) * 4
    rng = np.random.default_rng(0)
    tuples = np.stack([rng.integers(0, s, 64, dtype=np.int32)
                       for s in sizes], 1)
    miner = BatchMiner(sizes, device="cpu")
    assert not miner.key_plans[0].fits and not miner.packed_active
    assert_results_identical(JBatch(sizes)(tuples), miner(tuples))
    # the float value lane pushes a fitting prime key over the edge
    # (3×11+32 = 65 bits); rank-coded pruning brings it back under 64
    nsz = (2048, 2048, 2048)
    vals = rng.uniform(0, 100, 64).astype(np.float32)
    ntup = np.stack([rng.integers(0, s, 64, dtype=np.int32)
                     for s in nsz], 1)
    for prune in (False, True):
        nm = NOACMiner(nsz, delta=10.0, prune_values=prune, device="cpu")
        assert not nm.packed_active
        assert_results_identical(
            JNOAC(nsz, delta=10.0, prune_values=prune)(ntup, vals),
            nm(ntup, vals))


def test_jax_kernel_route_bit_identical():
    """The JAX pipeline with its Pallas kernels (interpret mode) gives the
    port's result too."""
    ctx = TS.random_context((7, 6, 5), 64, seed=3)
    assert_results_identical(JBatch(ctx.sizes, use_pallas=True)(ctx.tuples),
                             BatchMiner(ctx.sizes, device="cpu")(ctx.tuples))
    ctxv = TS.random_context((7, 6, 5), 64, seed=4, values=True)
    assert_results_identical(
        JNOAC(ctxv.sizes, delta=60.0, use_pallas=True)(ctxv.tuples,
                                                       ctxv.values),
        NOACMiner(ctxv.sizes, delta=60.0, device="cpu")(ctxv.tuples,
                                                        ctxv.values))


def _cluster_set(clusters):
    return {(tuple(tuple(sorted(c)) for c in comps), dens)
            for comps, dens in clusters}


@pytest.mark.parametrize("case", ["imdb_prime", "random_prime",
                                  "movielens_noac", "random_noac"])
def test_mine_registry_cluster_sets(case):
    make = {"imdb_prime": lambda S: (S.imdb_like(), {}),
            "random_prime": lambda S: (S.random_context((9, 8, 7), 300,
                                                        seed=12), {}),
            "movielens_noac": lambda S: (S.movielens_like(n_tuples=800),
                                         {"delta": 1.0}),
            "random_noac": lambda S: (S.random_context((6, 6, 6), 200,
                                                       seed=13, values=True),
                                      {"delta": 150.0, "minsup": 2})}[case]
    (jctx, params), (tctx, _) = make(JS), make(TS)
    variant = "noac" if "delta" in params else "prime"
    want = jmine(jctx, backend="batch", variant=variant, **params)
    got = mine(tctx, backend="batch", variant=variant, device="cpu",
               **params)
    assert got.n_clusters == want.n_clusters > 0
    assert _cluster_set(got.clusters) == _cluster_set(want.clusters)
    assert_results_identical(want.result, got.result)
    again = got.rerun()
    assert torch.equal(again.keep, got.result.keep)
    assert got.tuples_per_s > 0


def test_mine_registry_errors():
    ctx = TS.random_context((4, 4, 4), 30, seed=1)
    assert available_engines() == [("batch", "noac"), ("batch", "prime"),
                                   ("distributed", "noac"),
                                   ("distributed", "prime"),
                                   ("reference", "noac"),
                                   ("reference", "prime"),
                                   ("streaming", "noac"),
                                   ("streaming", "prime")]
    with pytest.raises(ValueError, match="valid combinations: "
                       "batch/noac, batch/prime, distributed/noac, "
                       "distributed/prime, reference/noac, "
                       "reference/prime, streaming/noac, streaming/prime"):
        mine(ctx, backend="spark", device="cpu")
    with pytest.raises(ValueError, match="requires delta"):
        mine(ctx, variant="noac", device="cpu")
    # the out-of-core budgets run and give the in-core result
    incore = mine(ctx, device="cpu").result
    jctx = JS.random_context((4, 4, 4), 30, seed=1)
    for budget in ("chunk_budget", "window_budget"):
        got = mine(ctx, device="cpu", **{budget: 8}).result
        assert_results_identical(jmine(jctx, **{budget: 8}).result, got)
        for f in ("sig_lo", "keep", "perms", "range_lo"):
            assert torch.equal(getattr(got, f), getattr(incore, f))
    miner = BatchMiner(ctx.sizes, device="cpu")
    want = JBatch(jctx.sizes)(jctx.tuples)
    assert_results_identical(want, miner.mine_chunked(ctx.tuples))
    assert_results_identical(want, miner.mine_windowed(ctx.tuples))
    assert mine(ctx, backend="streaming", device="cpu").n_clusters == \
        mine(ctx, backend="reference").n_clusters


def test_hash_vectors_and_mix_signatures():
    sizes = (17, 1, 300, 5)
    jvecs = JP.mode_hash_vectors(sizes, seed=0x5EED)
    tvecs = TP.mode_hash_vectors(sizes, seed=0x5EED)
    lo, hi = TP.hash_vectors_from_numpy(jvecs, "cpu")
    for (jl, jh), (tl, th), a, b in zip(jvecs, tvecs, lo, hi):
        np.testing.assert_array_equal(jl, tl)
        np.testing.assert_array_equal(jh, th)
        assert a.dtype == torch.int32 and b.dtype == torch.int32
        assert_same(a, jl, "lo")
        assert_same(b, jh, "hi")
    rng = np.random.default_rng(5)
    lanes = [rng.integers(0, 2**32, 400, dtype=np.uint64).astype(np.uint32)
             for _ in range(2 * 9)]                # 9 modes: _MIX wraps
    got = TP.mix_signatures([u32(x) for x in lanes[:9]],
                            [u32(x) for x in lanes[9:]])
    want = JP.mix_signatures([jnp.asarray(x) for x in lanes[:9]],
                             [jnp.asarray(x) for x in lanes[9:]])
    for g, w in zip(got, want):
        assert_same(g, w, "mix_signatures")


def test_segmentation_primitives():
    rng = np.random.default_rng(4)
    cols = [rng.integers(0, 4, 500).astype(np.int32) for _ in range(3)]
    vals = rng.integers(0, 3, 500).astype(np.float32)
    vals[::7] = -0.0                                # -0.0 sorts as 0.0
    tcols = [torch.from_numpy(c) for c in cols] + [torch.from_numpy(vals)]
    jcols = [jnp.asarray(c) for c in cols] + [jnp.asarray(vals)]
    perm = TP.lex_perm(tcols)
    assert_same(perm, JP.lex_perm(jcols), "lex_perm")
    s_t = [c[perm] for c in tcols]
    s_j = [c[JP.lex_perm(jcols)] for c in jcols]
    flags = TP.segment_starts(s_t[:2])
    assert_same(flags, JP.segment_starts(s_j[:2]), "segment_starts")
    for g, w in zip(TP.segment_bounds(flags), JP.segment_bounds(
            JP.segment_starts(s_j[:2]))):
        assert_same(g, w, "segment_bounds")
    sig = rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    tf = rng.random(300) < 0.5
    for packed in (True, False):
        got = TP.stage3_dedup(u32(sig), u32(sig[::-1].copy()),
                              torch.from_numpy(tf), packed=packed)
        want = JP.stage3_dedup(jnp.asarray(sig), jnp.asarray(sig[::-1]),
                               jnp.asarray(tf), packed=packed)
        for g, w in zip(got, want):
            assert_same(g, w, f"stage3_dedup packed={packed}")


def test_kept_sig_words_and_dirty_count():
    a, b = _same_context("random3", PRIME_CONTEXTS)
    jres = JBatch(a.sizes)(a.tuples)
    tres = BatchMiner(b.sizes, device="cpu")(b.tuples)
    words = TP.kept_sig_words(tres)
    np.testing.assert_array_equal(words, JP.kept_sig_words(jres))
    half = words[: words.size // 2]
    assert TP.dirty_sig_count(None, words) == JP.dirty_sig_count(None, words)
    assert (TP.dirty_sig_count(half, words)
            == JP.dirty_sig_count(half, words) == words.size - half.size)
    assert (sorted(map(repr, TP.materialise(tres, only_kept=False)))
            == sorted(map(repr, JP.materialise(jres, only_kept=False))))


def _count(out: str) -> int:
    return int(re.search(r"(\d+) (?:unique clusters|triclusters)",
                         out).group(1))


@pytest.mark.parametrize("args", [
    ["--dataset", "imdb", "--backend", "batch"],
    ["--dataset", "imdb", "--backend", "reference"],
    ["--dataset", "movielens", "--n-tuples", "600", "--delta", "1.0"],
    ["--dataset", "movielens", "--n-tuples", "600", "--delta", "1.0",
     "--backend", "reference"],
    ["--dataset", "random", "--n-tuples", "300", "--sort-backend", "lax",
     "--theta", "0.5"],
    ["--dataset", "imdb", "--backend", "distributed", "--strategy",
     "shuffle"],
    ["--dataset", "movielens", "--n-tuples", "512", "--backend",
     "distributed", "--delta", "1.0"],
    ["--dataset", "random", "--n-tuples", "512", "--backend",
     "distributed", "--incremental"],
])
def test_cli_twin_matches_jax_cli(args, capsys):
    assert jcli.main(args + ["--print-top", "0"]) == 0
    want = _count(capsys.readouterr().out)
    assert tcli.main(args + ["--device", "cpu", "--print-top", "1"]) == 0
    got = _count(capsys.readouterr().out)
    assert got == want > 0


@pytest.mark.parametrize("args", [
    ["--backend", "spark"],
    ["--backend", "distributed", "--variant", "noac"],
    ["--variant", "noac"],
])
def test_cli_twin_rejects_with_valid_choices(args, capsys):
    assert tcli.main(["--dataset", "imdb", "--device", "cpu"] + args) == 2
    err = capsys.readouterr().err
    assert ("valid backend/variant choices: batch/noac, batch/prime, "
            "distributed/noac, distributed/prime, reference/noac, "
            "reference/prime, streaming/noac, streaming/prime") in err
