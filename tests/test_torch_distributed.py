"""Parity of the port's distributed backend (``repro_torch.core.distributed``
over ``torch.distributed``) with the JAX package's ``DistributedMiner`` on
the CPU: at one rank (in-process; without a process group and over a gloo
group of one rank) every ``DistributedResult`` leaf bit for bit for both
strategies, both variants and every sort path, the overflow retry and its
final capacity factor; the shuffle's pieces on the same inputs (owner
hashing, the dispatch with forced overflow, the validity bit at 31, 32,
33 and 63 key bits, both owner stages on buffers with invalid slots, the
exactly-64-bit key); the incremental per-shard snapshots, the serving
snapshot (monolithic and windowed) and the registry; the mesh and its
collectives; and, in a subprocess, 8 gloo ranks against JAX on forced
8-host-device meshes, and the per-shard incremental stores at 4 and 8
ranks (``_torch_distributed_check.py``)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import assert_results_identical, assert_same, u32
from repro.core import DistributedMiner as JDist
from repro.core import distributed as JD
from repro.core import keys as JK
from repro.core import mine as jmine
from repro.data import synthetic as JS
from repro.launch.mesh import make_mesh as jmake_mesh
from repro_torch.core import (BatchMiner, DistributedMiner, DistributedResult,
                              NOACMiner, make_miner, mine)
from repro_torch.core import distributed as TD
from repro_torch.core import keys as TK
from repro_torch.core.collectives import Collectives
from repro_torch.data import synthetic as TS
from repro_torch.launch.mesh import (Mesh, coords_of, make_local_mesh,
                                     make_mesh, mesh_name)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONTEXTS = {
    "prime": (lambda S: S.bibsonomy_like(scale=0.002), {}),
    "noac": (lambda S: S.movielens_like(n_tuples=600, seed=1)
             .deduplicated(), {"delta": 1.0, "rho_min": 0.05}),
}


def _jmesh():
    return jmake_mesh((1,), ("data",))


def _values(ctx):
    return None if ctx.values is None else ctx.values


def assert_dist_identical(want, got: DistributedResult) -> None:
    """Every leaf of a JAX ``DistributedResult`` bit-identical."""
    for name in TD.LEAVES:
        assert_same(getattr(got, name), getattr(want, name), name)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of one rank, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("strategy,variant,backend", [
    ("replicate", "prime", None), ("replicate", "noac", None),
    ("shuffle", "prime", None), ("shuffle", "noac", None),
    ("shuffle", "prime", "lax"), ("shuffle", "noac", "lax"),
    ("shuffle", "prime", "lexsort"), ("shuffle", "noac", "lexsort"),
])
def test_one_rank_bit_identical_to_jax(strategy, variant, backend):
    make, kw = CONTEXTS[variant]
    jctx, tctx = make(JS), make(TS)
    want = JDist(jctx.sizes, _jmesh(), strategy=strategy,
                 sort_backend=backend, **kw)(jctx.tuples, _values(jctx))
    miner = DistributedMiner(tctx.sizes, make_local_mesh(device="cpu"),
                             strategy=strategy, sort_backend=backend, **kw)
    got = miner(tctx.tuples, _values(tctx))
    assert_dist_identical(want, got)
    assert got.gather() is got
    # and the single-device miner's leaves
    single = (NOACMiner(tctx.sizes, device="cpu", sort_backend=backend,
                        **kw)(tctx.tuples, tctx.values)
              if variant == "noac" else
              BatchMiner(tctx.sizes, device="cpu",
                         sort_backend=backend)(tctx.tuples))
    for name in ("sig_lo", "sig_hi", "gen_count", "keep", "cardinalities"):
        assert torch.equal(getattr(got, name), getattr(single, name)), name


@pytest.mark.parametrize("strategy", ["replicate", "shuffle"])
def test_group_of_one_rank(one_rank_group, strategy):
    """With a process group every collective goes through it, even at
    size 1; the result equals the group-less one (held against JAX's by
    ``test_one_rank_bit_identical_to_jax``)."""
    make, kw = CONTEXTS["noac"]
    tctx = make(TS)
    mesh = make_local_mesh(device="cpu")
    assert mesh.group is not None and mesh.shape == {"data": 1, "model": 1}
    assert not mesh.staged
    got = DistributedMiner(tctx.sizes, mesh, strategy=strategy,
                           **kw)(tctx.tuples, tctx.values)
    want = DistributedMiner(tctx.sizes, Mesh(("data",), (1,),
                                             torch.device("cpu")),
                            strategy=strategy, **kw)(tctx.tuples,
                                                     tctx.values)
    assert_dist_identical(want, got)
    gathered = got.gather()
    assert gathered is not got
    assert_dist_identical(want, gathered)
    run = mine(tctx, backend="distributed", variant="noac",
               strategy=strategy, device="cpu", **kw)
    assert run.n_clusters == int(got.keep.sum()) > 0


def test_overflow_retry_matches_jax():
    ctx_j = JS.random_context((9, 8, 7), 200, seed=5)
    ctx_t = TS.random_context((9, 8, 7), 200, seed=5)
    jm = JDist(ctx_j.sizes, _jmesh(), strategy="shuffle",
               capacity_factor=0.5)
    tm = DistributedMiner(ctx_t.sizes, make_local_mesh(device="cpu"),
                          strategy="shuffle", capacity_factor=0.5)
    want, got = jm(ctx_j.tuples), tm(ctx_t.tuples)
    assert tm.capacity_factor == jm.capacity_factor == 1.0
    assert_dist_identical(want, got)
    with pytest.raises(RuntimeError, match="overflow persists"):
        DistributedMiner(ctx_t.sizes, make_local_mesh(device="cpu"),
                         strategy="shuffle", capacity_factor=0.25,
                         max_retries=1)(ctx_t.tuples)
    with pytest.raises(ValueError, match="not divisible"):
        DistributedMiner(ctx_t.sizes, Mesh(("data",), (2,), torch.device(
            "cpu")))(ctx_t.tuples[:7])


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_hash_columns_and_owner(n_shards):
    rng = np.random.default_rng(n_shards)
    cols = [rng.integers(0, 2**31 - 1, 500, dtype=np.int64).astype(np.int32)
            for _ in range(3)]
    want = JD._hash_columns([jnp.asarray(c) for c in cols], 0xA11CE + 2)
    got = TD._hash_columns([torch.from_numpy(c) for c in cols], 0xA11CE + 2)
    assert_same(got, want, "hash")
    assert_same(TD._hash_owner(got, n_shards),
                (want % jnp.uint32(n_shards)).astype(jnp.int32), "owner")


@pytest.mark.parametrize("capacity", [1, 7, 40])
def test_dispatch_with_forced_overflow(capacity):
    rng = np.random.default_rng(capacity)
    records = rng.integers(-2**31, 2**31 - 1, (300, 3),
                           dtype=np.int64).astype(np.int32)
    owner = np.minimum(rng.geometric(0.3, 300) - 1, 3).astype(np.int32)
    want = JD._dispatch(jnp.asarray(records), jnp.asarray(owner), 4,
                        capacity)
    got = TD._dispatch(torch.from_numpy(records), torch.from_numpy(owner), 4,
                       capacity)
    for g, w, what in zip(got, want, ("buf", "valid", "slot", "ok",
                                      "overflow")):
        assert_same(g, w, what)
    assert int(got[-1]) > 0 or capacity == 40


def _random_words(rng, total_bits, t):
    """msb-first uint32 words of random ``total_bits``-bit keys."""
    keys = rng.integers(0, 2**64, t, dtype=np.uint64) >> np.uint64(
        64 - total_bits)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    return (lo,) if total_bits <= 32 else (hi, lo)


@pytest.mark.parametrize("total_bits", [31, 32, 33, 63])
def test_validity_words(total_bits):
    rng = np.random.default_rng(total_bits)
    words = _random_words(rng, total_bits, 257)
    inval = (rng.random(257) < 0.5).astype(np.uint32)
    want = JD._validity_words(tuple(jnp.asarray(w) for w in words),
                              jnp.asarray(inval), total_bits)
    got = TD._validity_words(tuple(u32(w) for w in words),
                             torch.from_numpy(inval.astype(np.int32)),
                             total_bits)
    assert len(got) == len(want) == (1 if total_bits < 32 else 2)
    for g, w in zip(got, want):
        assert_same(g, w, f"validity words {total_bits}")


#: (sizes, with_values, value_slots): prime keys of 31, 33, 63 and exactly
#: 64 bits; NOAC keys with the float lane and with a rank-coded lane
PLANS = {
    "prime31": ((2**10, 2**11, 2**10), False, None),
    "prime33": ((2**11, 2**11, 2**11), False, None),
    "prime63": ((2**21, 2**21, 2**21), False, None),
    "prime64": ((2**22, 2**21, 2**21), False, None),
    "noac_float": ((40, 30, 5), True, None),
    "noac_rank": ((40, 30, 5), True, 9),
}


def _owner_buffers(name, seed=0, t=301):
    """A received buffer of packed records of one mode's plan — about
    half its slots invalid (zeros, as the dispatch leaves them) — with
    hash lanes and a value domain, for both packages."""
    sizes, with_values, slots = PLANS[name]
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.integers(0, min(s, 6), t) for s in sizes],
                    1).astype(np.int32)      # few ids: real segments
    dom = np.arange(slots, dtype=np.float32) * 0.5 if slots else None
    vals = (rng.choice(dom, t) if slots else
            rng.integers(0, 6, t).astype(np.float32) * 0.5) \
        if with_values else None
    tplan = TK.plan_context_keys(sizes, with_values, slots)[1]
    jplan = JK.plan_context_keys(sizes, with_values, slots)[1]
    key = tplan.pack_host(rows, vals, dom)
    assert np.array_equal(key, jplan.pack_host(rows, vals, dom))
    if name.startswith("prime"):
        assert tplan.total_bits == int(name[len("prime"):])
    valid = rng.random(t) < 0.5
    key = np.where(valid, key, np.uint64(0))
    words = ([(key >> np.uint64(32)).astype(np.uint32)]
             if tplan.words == 2 else []) + [
        (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)]
    recv = np.stack(words, 1)
    r_lo = rng.integers(1, 2**32, sizes[1], dtype=np.uint64).astype(
        np.uint32)
    r_hi = rng.integers(1, 2**32, sizes[1], dtype=np.uint64).astype(
        np.uint32)
    return tplan, jplan, recv, valid, r_lo, r_hi, dom


@pytest.mark.parametrize("backend", ["radix", "lax"])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_owner_stage_packed_with_invalid_slots(name, backend):
    tplan, jplan, recv, valid, r_lo, r_hi, dom = _owner_buffers(name)
    delta = 0.5 if jplan.with_values else None
    want = JD._owner_stage_packed(
        jnp.asarray(recv), jnp.asarray(valid), jplan, jnp.asarray(r_lo),
        jnp.asarray(r_hi), delta, sort_backend=backend,
        value_domain=None if dom is None else jnp.asarray(dom))
    got = TD._owner_stage_packed(
        u32(recv), torch.from_numpy(valid), tplan, u32(r_lo), u32(r_hi),
        delta, sort_backend=backend,
        value_domain=None if dom is None else torch.from_numpy(dom))
    for g, w, what in zip(got, want, ("sig_lo", "sig_hi", "distinct",
                                      "tuple_first")):
        assert_same(g, w, what)


@pytest.mark.parametrize("valued", [False, True])
def test_owner_stage_columns_with_invalid_slots(valued):
    rng = np.random.default_rng(7)
    t = 300
    cols = [rng.integers(0, 5, t).astype(np.int32) for _ in range(3)]
    if valued:
        vals = rng.integers(-3, 4, t).astype(np.float32) * 0.25
        vals[::11] = -0.0
        cols.append(vals.view(np.int32))
    valid = rng.random(t) < 0.5
    recv = np.where(valid[:, None], np.stack(cols, 1), 0).astype(np.int32)
    r_lo = rng.integers(1, 2**32, 5, dtype=np.uint64).astype(np.uint32)
    r_hi = rng.integers(1, 2**32, 5, dtype=np.uint64).astype(np.uint32)
    delta = 0.25 if valued else None
    want = JD._owner_stage(jnp.asarray(recv), jnp.asarray(valid), 2,
                           jnp.asarray(r_lo), jnp.asarray(r_hi), delta)
    got = TD._owner_stage(torch.from_numpy(recv), torch.from_numpy(valid), 2,
                          u32(r_lo), u32(r_hi), delta)
    for g, w, what in zip(got, want, ("sig_lo", "sig_hi", "distinct",
                                      "tuple_first")):
        assert_same(g, w, what)


def _kept_sigs(res):
    keep = res.keep.numpy()
    return set(zip(res.sig_lo.numpy()[keep].tolist(),
                   res.sig_hi.numpy()[keep].tolist()))


@pytest.mark.parametrize("variant", ["prime", "noac"])
def test_incremental_snapshots_match_jax(variant):
    """Twin of the JAX package's incremental distributed snapshot test:
    every snapshot (incremental, ``full_remine``, serving) equals JAX's
    leaf for leaf, its kept signatures equal a batch mine of the seen
    rows, and the stream counters agree."""
    if variant == "prime":
        jctx = JS.random_context((9, 8, 7), 160, seed=8)
        kw = {}
    else:
        jctx = JS.random_context((8, 7, 6), 120, seed=9,
                                 values=True).deduplicated()
        kw = dict(delta=60.0, rho_min=0.2, minsup=1)
    jm = JDist(jctx.sizes, _jmesh(), **kw)
    tm = DistributedMiner(jctx.sizes, make_local_mesh(device="cpu"), **kw)
    # ``loop`` snapshots after every chunk; ``tm`` mirrors ``jm``'s calls,
    # so their stream counters can be compared
    loop = DistributedMiner(jctx.sizes, make_local_mesh(device="cpu"), **kw)
    bm = (NOACMiner if kw else BatchMiner)(jctx.sizes, device="cpu", **kw)
    vals = jctx.values
    chunk = -(-jctx.num_tuples // 4)
    for lo in range(0, jctx.num_tuples, chunk):
        hi = lo + chunk
        v = None if vals is None else vals[lo:hi]
        for m in (jm, tm, loop):
            m.ingest(jctx.tuples[lo:hi], v)
        assert tm.stream_count == jm.stream_count == min(hi, len(jctx.tuples))
        seen = (bm(jctx.tuples[:hi]) if vals is None
                else bm(jctx.tuples[:hi], vals[:hi]))
        assert _kept_sigs(loop.snapshot()) == _kept_sigs(seen)
        assert _kept_sigs(loop.snapshot(full_remine=True)) == \
            _kept_sigs(seen)
    assert loop.stream_stats["full_resorts"] == 4
    assert loop.stream_stats["merged_rows"] > 0
    assert_dist_identical(jm.snapshot(), tm.snapshot())
    assert_dist_identical(jm.snapshot(full_remine=True),
                          tm.snapshot(full_remine=True))
    serving = tm.serving_snapshot()
    assert_results_identical(jm.serving_snapshot(), serving)
    full = tm.serving_snapshot(full_remine=True)
    for name in ("sig_lo", "sig_hi", "keep", "perms", "range_lo"):
        assert torch.equal(getattr(full, name), getattr(serving, name))
    assert tm.stream_stats == dict(jm.stream_stats, snapshots=4,
                                   full_resorts=2)
    assert tm.stream_version == jm.stream_version == 4
    tm.delete(jctx.tuples[:5])
    jm.delete(jctx.tuples[:5])
    assert_dist_identical(jm.snapshot(), tm.snapshot())
    # the shuffle strategy mines its stream one-shot only
    ts = DistributedMiner(jctx.sizes, make_local_mesh(device="cpu"),
                          strategy="shuffle", **kw)
    ts.ingest(jctx.tuples, vals)
    ts.delete(jctx.tuples[:5])
    with pytest.raises(ValueError, match="one-shot only"):
        ts.snapshot()
    assert_dist_identical(jm.snapshot(), ts.snapshot(full_remine=True))
    tm.reset_stream()
    assert tm.stream_count == 0
    with pytest.raises(ValueError, match="no data"):
        tm.snapshot()


@pytest.mark.parametrize("window_budget", [None, 19])
def test_serving_snapshot_windowed_matches_jax(window_budget):
    """Twin of ``test_distributed_serving_snapshot_windowed``: the
    registry's incremental distributed run, its serving snapshot
    monolithic and windowed, equal JAX's and each other's."""
    ctx = TS.random_context((9, 7, 5), 128, seed=19)
    jctx = JS.random_context((9, 7, 5), 128, seed=19)
    kw = {} if window_budget is None else {"window_budget": window_budget}
    got = mine(ctx, backend="distributed", incremental=True, device="cpu",
               **kw)
    want = jmine(jctx, backend="distributed", incremental=True, **kw)
    assert got.n_clusters == want.n_clusters > 0
    assert_dist_identical(want.result, got.result)
    got.miner.track_dirty_sigs = want.miner.track_dirty_sigs = True
    snap = got.miner.serving_snapshot()
    assert_results_identical(want.miner.serving_snapshot(), snap)
    assert_results_identical(
        mine(ctx, backend="distributed", incremental=True,
             device="cpu").miner.serving_snapshot(), snap)
    assert got.miner.last_dirty_sigs == want.miner.last_dirty_sigs > 0


def test_registry_backends_agree():
    """Twin of the JAX package's ``test_registry_backends_agree``, with
    the distributed backend in it."""
    ctx = TS.random_context((6, 5, 4), 64, seed=4, values=True)
    jctx = JS.random_context((6, 5, 4), 64, seed=4, values=True)
    counts = {b: mine(ctx, backend=b, variant="noac", delta=40.0,
                      device="cpu").n_clusters
              for b in ("batch", "streaming", "reference", "distributed")}
    counts["jax distributed"] = jmine(jctx, backend="distributed",
                                      variant="noac", delta=40.0).n_clusters
    assert len(set(counts.values())) == 1, counts
    inc = mine(ctx, backend="distributed", variant="noac", delta=40.0,
               incremental=True, chunks=4, device="cpu")
    assert inc.n_clusters == counts["batch"]
    assert inc.miner.stream_stats["snapshots"] == 1


def test_mesh_and_collectives():
    mesh = make_local_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.group, mesh_name(mesh)) \
        == ({"data": 1, "model": 1}, 0, None, "1x1")
    assert make_local_mesh(pod=1, device="cpu").axis_names == (
        "pod", "data", "model")
    assert make_mesh((1,), ("data",), device="cpu").shape == {"data": 1}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((2,), ("data",), device="cpu")
    comm = Collectives(mesh, "data")
    x = torch.arange(6, dtype=torch.int32)
    assert comm.size == 1 and comm.index() == 0
    for op in (comm.all_gather, comm.all_to_all, comm.psum, comm.pmax):
        assert op(x) is x
    # a sub-mesh's collectives (A9b) are taken; without a process group
    # the mesh is one rank, at position 0, and they are the identity;
    # rank r sits at row-major position r
    wide = Mesh(("data", "model"), (2, 2), torch.device("cpu"))
    for axes, size in (("data", 2), (("model", "data"), 4)):
        sub = Collectives(wide, axes)
        assert (sub.size, sub.index(), sub.group) == (size, 0, None)
        assert sub.psum(x) is x
    assert [coords_of(r, (2, 2)) for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert coords_of(5, (2, 2, 2)) == (1, 0, 1)
    with pytest.raises(ValueError, match="not mesh axes"):
        Collectives(mesh, "pod")
    assert Collectives(wide, ("data", "model")).size == 4
    miner = DistributedMiner((4, 4, 4), mesh)
    assert miner.device == torch.device("cpu") and miner.n_shards == 1
    with pytest.raises(NotImplementedError, match="A13g"):
        miner.lowered(np.zeros((4, 3), np.int32))
    with pytest.raises(ValueError, match="needs a mesh"):
        make_miner((4, 4, 4), backend="distributed", device="cpu")
    got = make_miner((4, 4, 4), backend="distributed", mesh=mesh, delta=1.0,
                     strategy="shuffle", device="cpu")
    assert (got.delta, got.strategy) == (1.0, "shuffle")
    with pytest.raises(ValueError):
        DistributedMiner((4, 4, 4), mesh, strategy="scatter")


def test_eight_gloo_ranks_match_jax_on_forced_host_meshes():
    """8 spawned gloo ranks of the port against JAX's DistributedMiner on
    forced 8-device (8,) and (2, 4) meshes: prime replicate and shuffle,
    NOAC shuffle over ("pod", "data"), an overflow retried to JAX's final
    capacity factor, and a skewed context on the hash fallback."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         os.path.join(ROOT, "tests")])
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_distributed_check.py")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[-1] == "OK"
    assert "skewed_hash_fallback: 10 leaves equal" in proc.stdout
    assert "incremental_stream serving at 8 ranks: 12 leaves equal" \
        in proc.stdout


def test_four_gloo_ranks_incremental_snapshots_match_jax():
    """The per-shard incremental stores at 4 gloo ranks (the 8-rank run
    above covers 8): ``ingest`` in chunks and a delete, then
    ``snapshot``, ``snapshot(full_remine=True)`` and ``serving_snapshot``
    against JAX's on a forced 4-device mesh, leaf for leaf; and mining
    over a sub-mesh (A9b): a (2, 2) ``(data, model)`` mesh mined over
    ``data`` alone, replicated over ``model``, prime shuffle and NOAC
    replicate, every leaf bit for bit."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         os.path.join(ROOT, "tests")])
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_distributed_check.py"), "4"],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "OK"
    for what, n in (("snapshot", 10), ("full_remine", 10), ("serving", 12)):
        assert f"incremental_stream {what} at 4 ranks: {n} leaves equal" \
            in lines
    for name in ("prime_shuffle_submesh", "noac_replicate_submesh"):
        assert any(ln.startswith(f"{name}: 10 leaves equal")
                   for ln in lines), name
