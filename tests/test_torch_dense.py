"""Parity of the port's dense validation path and reference backend with
the JAX package on the CPU: ``dense_tensor``, ``fibers`` and
``exact_density_dense`` against their JAX twins (triadic and 4-ary); the
signature identity (the fibers hashed by ``set_signature`` and mixed give
the pipeline's ``sig_lo``/``sig_hi``, and their sums its cardinalities);
exact densities against the numpy oracle; the reference engines,
``postprocess`` and ``make_miner`` against the JAX registry; and the CLI
twin's ``--backend reference``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same
from repro.core import BatchMiner as JBatch
from repro.core import NOACMiner as JNOAC
from repro.core import batch as JB
from repro.core import make_miner as jmake_miner
from repro.core import mine as jmine
from repro.core import pipeline as JP
from repro.core import postprocess as JPP
from repro.core import reference as JR
from repro.data import synthetic as JS
from repro_torch.core import (BatchMiner, DistributedMiner, NOACMiner,
                              StreamingMiner, dense_tensor, exact_density_dense, fibers,
                              make_miner, mine)
from repro_torch.core import pipeline as TP
from repro_torch.core import postprocess as PP
from repro_torch.core import reference as R
from repro_torch.data import synthetic as TS
from repro_torch.kernels import ops
from repro_torch.launch import tricluster as tcli
from repro_torch.launch.mesh import make_local_mesh

CONTEXTS = {
    "random3": lambda S: S.random_context((6, 5, 4), 50, seed=7),
    "imdb": lambda S: S.imdb_like(),
    "k1": lambda S: S.k1_dense_cube(n=8),
    "random4": lambda S: S.random_context((5, 4, 3, 6), 200, seed=5),
    "k3": lambda S: S.k3_dense_4d(n=5),
    "duplicates": lambda S: S.random_context((3, 3, 3), 100, seed=6),
}


def _pair(name):
    j, t = CONTEXTS[name](JS), CONTEXTS[name](TS)
    np.testing.assert_array_equal(j.tuples, t.tuples)
    return j, t


def _dense(ctx):
    tup = torch.from_numpy(ctx.tuples)
    tens = dense_tensor(tup, ctx.sizes)
    return tup, tens, fibers(tens, tup)


@pytest.mark.parametrize("name", sorted(CONTEXTS))
def test_dense_backend_matches_jax(name):
    jctx, tctx = _pair(name)
    jt = jnp.asarray(jctx.tuples)
    jtens = JB.dense_tensor(jt, jctx.sizes)
    jmasks = JB.fibers(jtens, jt)
    _, tens, masks = _dense(tctx)
    assert tens.dtype == torch.bool and tens.shape == tuple(tctx.sizes)
    assert_same(tens, jtens, "dense_tensor")
    assert len(masks) == len(jmasks)
    for k, (m, jm) in enumerate(zip(masks, jmasks)):
        assert_same(m, jm, f"fibers[{k}]")
    got = exact_density_dense(tens, masks)
    assert_same(got, JB.exact_density_dense(jtens, jmasks),
                "exact_density_dense")


@pytest.mark.parametrize("name", ["random3", "k1", "random4"])
def test_exact_density_matches_the_numpy_oracle(name):
    """Each tuple's exact density equals ``reference.exact_density`` of its
    cluster (rel 1e-5, as ``tests/test_core_batch.py`` asks); the numerator
    is an integer at least the Alg. 7 generating-tuple count."""
    _, ctx = _pair(name)
    _, tens, masks = _dense(ctx)
    dens = exact_density_dense(tens, masks).numpy()
    res = BatchMiner(ctx.sizes, device="cpu")(ctx.tuples)
    for i, row in enumerate(map(tuple, ctx.tuples.tolist())):
        cluster = tuple(R.cumulus(ctx, row, k) for k in range(ctx.arity))
        assert dens[i] == pytest.approx(R.exact_density(ctx, cluster),
                                        rel=1e-5)
    num = dens * res.volume.numpy()
    np.testing.assert_allclose(num, np.round(num), rtol=1e-5)
    assert (np.round(num) >= res.gen_count.numpy()).all()


@pytest.mark.parametrize("name", ["random3", "imdb", "k1", "random4",
                                  "duplicates"])
def test_signature_identity_with_the_pipeline(name):
    """The fibers hashed by ``set_signature`` and mixed are the pipeline's
    cluster signatures, bit for bit, and their sums its cardinalities —
    for the port's result and the JAX package's alike."""
    jctx, ctx = _pair(name)
    res = BatchMiner(ctx.sizes, device="cpu")(ctx.tuples)
    jres = JBatch(jctx.sizes)(jctx.tuples)
    _, _, masks = _dense(ctx)
    lo, hi = TP.hash_vectors_from_numpy(TP.mode_hash_vectors(ctx.sizes))
    sig_lo, sig_hi = TP.mix_signatures(
        [ops.set_signature(m, r) for m, r in zip(masks, lo)],
        [ops.set_signature(m, r) for m, r in zip(masks, hi)])
    assert torch.equal(sig_lo, res.sig_lo) and torch.equal(sig_hi, res.sig_hi)
    assert_same(sig_lo, jres.sig_lo, "sig_lo")
    assert_same(sig_hi, jres.sig_hi, "sig_hi")
    card = torch.stack([m.sum(-1).to(torch.int32) for m in masks])
    assert torch.equal(card, res.cardinalities)
    assert_same(card, jres.cardinalities, "cardinalities")


def test_dense_tensor_refuses_an_int32_overflow():
    tup = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 flat index"):
        dense_tensor(tup, (2_337, 67_464, 28_920))      # BibSonomy's cells
    assert dense_tensor(tup, (2, 2, 2)).sum() == 1


@pytest.mark.parametrize("variant,name,kw", [
    ("prime", "imdb", {}),
    ("prime", "random4", {"theta": 0.3}),
    ("noac", "movielens", {"delta": 1.0}),
    ("noac", "random_values", {"delta": 60.0, "rho_min": 0.2}),
    ("noac", "movielens", {"delta": 1.0, "minsup": 2}),
])
def test_reference_engines_match_jax(variant, name, kw):
    make = {"imdb": lambda S: S.imdb_like(),
            "random4": lambda S: S.random_context((5, 4, 3, 6), 200, seed=5),
            "movielens": lambda S: S.movielens_like(n_tuples=1500, seed=1),
            "random_values": lambda S: S.random_context(
                (7, 6, 5), 150, seed=4, values=True)}[name]
    want = jmine(make(JS), backend="reference", variant=variant, **kw)
    got = mine(make(TS), backend="reference", variant=variant, **kw)
    assert got.backend == "reference" and got.miner is None
    assert got.n_clusters == want.n_clusters > 0
    assert PP.cluster_set(got.clusters) == JPP.cluster_set(want.clusters)
    dens = {tuple(tuple(sorted(c)) for c in cl): d for cl, d in got.clusters}
    for cl, d in want.clusters:
        key = tuple(tuple(sorted(c)) for c in cl)
        assert dens[key] == d or (d != d and dens[key] != dens[key])
    # the reference agrees with the port's own batch engine
    batch = mine(make(TS), backend="batch", variant=variant, device="cpu",
                 **kw)
    assert PP.cluster_set(batch.clusters) == PP.cluster_set(got.clusters)


@pytest.mark.parametrize("kw", [
    {}, {"min_density": 0.5}, {"min_gen": 2}, {"max_volume": 6.0},
    {"min_cardinality": 2},
])
def test_postprocess_matches_jax(kw):
    jctx, ctx = _pair("imdb")
    res = BatchMiner(ctx.sizes, device="cpu")(ctx.tuples)
    jres = JBatch(jctx.sizes)(jctx.tuples)
    idx = PP.select(res, **kw)
    np.testing.assert_array_equal(idx, JPP.select(jres, **kw))
    np.testing.assert_array_equal(PP.top_k_by_density(res, 25),
                                  JPP.top_k_by_density(jres, 25))
    comps = [frozenset({3, 1}), frozenset({2})]
    assert PP.format_cluster(comps, density=0.5) == JPP.format_cluster(
        comps, density=0.5)
    names = [["a", "b", "c", "d"], ["x", "y", "z"]]
    assert PP.format_cluster(comps, names=names) == JPP.format_cluster(
        comps, names=names)


def test_make_miner_matches_jax():
    jctx, ctx = _pair("random3")
    got = make_miner(ctx.sizes, device="cpu")
    assert isinstance(got, BatchMiner)
    assert_same(got(ctx.tuples).sig_lo,
                jmake_miner(jctx.sizes)(jctx.tuples).sig_lo, "prime")
    mctx = TS.movielens_like(n_tuples=800, seed=2).deduplicated()
    jm = JS.movielens_like(n_tuples=800, seed=2).deduplicated()
    got = make_miner(mctx.sizes, delta=1.0, rho_min=0.1, device="cpu")
    assert isinstance(got, NOACMiner)
    want = jmake_miner(jm.sizes, delta=1.0, rho_min=0.1)
    assert isinstance(want, JNOAC)
    assert_same(got(mctx.tuples, mctx.values).keep,
                want(jm.tuples, jm.values).keep, "noac keep")
    with pytest.raises(ValueError, match="no miner object"):
        make_miner(ctx.sizes, backend="reference")
    with pytest.raises(ValueError, match="no engine"):
        make_miner(ctx.sizes, backend="nope")
    dm = make_miner(ctx.sizes, backend="distributed",
                    mesh=make_local_mesh(device="cpu"), device="cpu")
    assert isinstance(dm, DistributedMiner)
    assert_same(dm(ctx.tuples).sig_lo,
                jmake_miner(jctx.sizes)(jctx.tuples).sig_lo, "distributed")
    streaming = make_miner(ctx.sizes, backend="streaming", device="cpu")
    assert isinstance(streaming, StreamingMiner)
    streaming.add(ctx.tuples)
    assert_same(streaming.snapshot().sig_lo[:ctx.num_tuples],
                jmake_miner(jctx.sizes)(jctx.tuples).sig_lo, "streaming")


def test_cli_reference_backend(capsys):
    rc = tcli.main(["--dataset", "imdb", "--backend", "reference",
                    "--device", "cpu", "--print-top", "1"])
    ref_out = capsys.readouterr().out
    assert rc == 0, ref_out
    rc = tcli.main(["--dataset", "imdb", "--backend", "batch", "--device",
                    "cpu", "--print-top", "1"])
    batch_out = capsys.readouterr().out
    assert rc == 0, batch_out

    def count(out):
        line = [ln for ln in out.splitlines() if "unique clusters" in ln][0]
        return int(line.split(":")[1].split()[0])
    assert count(ref_out) == count(batch_out) == 3237
    assert "# density=" in ref_out
