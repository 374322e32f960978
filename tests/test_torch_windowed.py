"""Parity of the port's out-of-core paths (``PipelineMiner.mine_windowed``
over ``repro_torch.core.windowed``, and ``mine_chunked``) with the JAX
package's and with the port's own in-core ``__call__``: every
``PipelineResult`` leaf bit for bit, for prime and NOAC, the radix and
lax sort backends, and budgets from one row to the whole table; the
seam-adversarial layouts of ``tests/test_window_property.py``; the
guards; and the CPU half of ``core.memprobe``.  The JAX side runs on the
CPU, its kernels through their jnp oracles."""
import numpy as np
import pytest
import torch

from _torch_parity import assert_results_identical
from repro.core import BatchMiner as JBatch
from repro.core import NOACMiner as JNOAC
from repro.core import windowed as JWD
from repro_torch.core import BatchMiner, NOACMiner, mine
from repro_torch.core import memprobe as MP
from repro_torch.core import pipeline as TP
from repro_torch.core import radix as RX
from repro_torch.core import runs as TR
from repro_torch.core import windowed as WD
from repro_torch.core.context import PolyadicContext

T = 120


def _leaves_equal(a, b):
    """Both port results, leaf for leaf, dtype and bits."""
    for name in a.__dataclass_fields__:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        assert torch.equal(x.cpu(), y.cpu()), name


def _random_ctx(rng, sizes, t, values):
    """Random context; valued contexts get unique tuples (V is a function
    of the tuple, and the run store treats a valued add as an upsert)."""
    if values:
        total = int(np.prod(sizes))
        flat = rng.choice(total, min(t, total), replace=False)
        tuples = np.stack(np.unravel_index(flat, sizes), 1).astype(np.int32)
        vals = rng.uniform(0.001, 1000.0, tuples.shape[0]).astype(np.float32)
        return tuples, vals
    return np.stack([rng.integers(0, s, t, dtype=np.int32)
                     for s in sizes], 1), None


def _giant_segment_ctx(t, values=False, seed=0):
    """Mode 2's key segment (the other two columns) covers the whole
    table, so any budget below t carries it across every seam; the prime
    table has duplicate rows."""
    rng = np.random.default_rng(seed)
    if values:
        e = rng.permutation(t).astype(np.int32)
        sizes = (2, 2, t)
        vals = rng.uniform(0.0, 10.0, t).astype(np.float32)
    else:
        e = rng.integers(0, max(2, t // 2), t, dtype=np.int32)
        sizes = (2, 2, max(2, t // 2))
        vals = None
    tuples = np.stack([np.zeros(t, np.int32), np.zeros(t, np.int32), e], 1)
    return sizes, tuples, vals


def _three_way(sizes, tuples, vals, budget, backend, delta=None):
    """JAX windowed, port windowed and port in-core on one table."""
    if delta is None:
        jm = JBatch(sizes, sort_backend=backend)
        tm = BatchMiner(sizes, sort_backend=backend, device="cpu")
        want = jm.mine_windowed(tuples, window_budget=budget)
        got = tm.mine_windowed(tuples, window_budget=budget)
        incore = tm(tuples)
    else:
        jm = JNOAC(sizes, delta=delta, sort_backend=backend)
        tm = NOACMiner(sizes, delta=delta, sort_backend=backend,
                       device="cpu")
        want = jm.mine_windowed(tuples, values=vals, window_budget=budget)
        got = tm.mine_windowed(tuples, values=vals, window_budget=budget)
        incore = tm(tuples, vals)
    assert all(getattr(got, f).device.type == "cpu"
               for f in got.__dataclass_fields__)
    assert_results_identical(want, got)
    _leaves_equal(incore, got)
    return got


@pytest.mark.parametrize("backend", ["radix", "lax"])
@pytest.mark.parametrize("budget", [1, 3, 7, 40, T, None])
def test_windowed_prime(backend, budget):
    rng = np.random.default_rng(3)
    tuples, _ = _random_ctx(rng, (9, 7, 5), T, values=False)
    _three_way((9, 7, 5), tuples, None, budget, backend)


@pytest.mark.parametrize("backend", ["radix", "lax"])
@pytest.mark.parametrize("budget", [1, 3, 7, 25, 100, None])
@pytest.mark.parametrize("delta", [0.0, 1.0])
def test_windowed_noac(backend, budget, delta):
    sizes = (7, 6, 5)
    rng = np.random.default_rng(11)
    tuples, vals = _random_ctx(rng, sizes, 100, values=True)
    vals = np.round(vals / 200.0).astype(np.float32)   # ties within δ
    _three_way(sizes, tuples, vals, budget, backend, delta=delta)


@pytest.mark.parametrize("budget", [5, 16, 49])
def test_single_segment_spans_many_windows(budget):
    sizes, tuples, _ = _giant_segment_ctx(200, seed=1)
    assert -(-200 // budget) >= 3
    _three_way(sizes, tuples, None, budget, "radix")


@pytest.mark.parametrize("budget", [7, 32])
def test_delta_window_straddles_seams(budget):
    sizes, tuples, vals = _giant_segment_ctx(150, values=True, seed=2)
    _three_way(sizes, tuples, vals, budget, "radix", delta=5.0)


@pytest.mark.parametrize("budget", [1, 2, 9])
def test_duplicate_rows_across_seams(budget):
    rng = np.random.default_rng(7)
    base, _ = _random_ctx(rng, (4, 3, 3), 30, values=False)
    tuples = np.concatenate([base, base, base[:11]], 0)
    _three_way((4, 3, 3), tuples, None, budget, "radix")


def test_windowed_function_direct():
    """``core.windowed.mine_windowed`` itself against the JAX function,
    on a run store's merged permutations, with the memory probe."""
    import jax.numpy as jnp
    from repro.core import keys as JK
    from repro.core import pipeline as JP
    from repro.core import runs as JR
    sizes = (8, 6, 4)
    rng = np.random.default_rng(5)
    tuples, vals = _random_ctx(rng, sizes, 90, values=True)
    tplans = TP.K.plan_context_keys(sizes, with_values=True)
    store = TR.RunStore(tplans)
    store.add(tuples, vals)
    store.prepare()
    rows, v = store.table()
    vecs = TP.mode_hash_vectors(sizes)
    lo, hi = TP.hash_vectors_from_numpy(vecs, "cpu")
    probe = MP.MemProbe("cpu")
    got = WD.mine_windowed(rows, v, store.perms(), plans=tplans, hash_lo=lo,
                           hash_hi=hi, delta=300.0, theta=0.0, minsup=2,
                           window_budget=17, device="cpu", probe=probe)
    jstore = JR.RunStore(JK.plan_context_keys(sizes, with_values=True))
    jstore.add(tuples, vals)
    jstore.prepare()
    want = JWD.mine_windowed(
        rows, v, jstore.perms(),
        plans=JK.plan_context_keys(sizes, with_values=True),
        hash_lo=[jnp.asarray(a) for a, _ in JP.mode_hash_vectors(sizes)],
        hash_hi=[jnp.asarray(b) for _, b in JP.mode_hash_vectors(sizes)],
        delta=300.0, theta=0.0, minsup=2, window_budget=17)
    assert_results_identical(want, got)
    assert int(got.keep.sum()) > 0
    assert sorted(probe.stages) == sorted(WD.STAGES)
    assert probe.report()["peak_bytes"] == probe.peak_bytes >= 0


@pytest.mark.parametrize("budget", [1, 11, 45, None])
@pytest.mark.parametrize("variant", ["prime", "noac"])
def test_mine_chunked(budget, variant):
    sizes, tuples, vals = _giant_segment_ctx(120, values=variant == "noac",
                                             seed=23)
    if variant == "noac":
        jm = JNOAC(sizes, delta=1.0, prune_values=False)
        tm = NOACMiner(sizes, delta=1.0, prune_values=False, device="cpu")
        want = jm.mine_chunked(tuples, values=vals, chunk_budget=budget)
        stats = {}
        got = tm.mine_chunked(tuples, values=vals, chunk_budget=budget,
                              stats=stats)
        incore = tm(tuples, vals)
    else:
        jm, tm = JBatch(sizes), BatchMiner(sizes, device="cpu")
        want = jm.mine_chunked(tuples, chunk_budget=budget)
        stats = {}
        got = tm.mine_chunked(tuples, chunk_budget=budget, stats=stats)
        incore = tm(tuples)
    assert_results_identical(want, got)
    _leaves_equal(incore, got)
    assert stats["chunk_sorted_rows"] == 120


def test_mine_chunked_iterable_and_wide_key():
    rng = np.random.default_rng(8)
    tuples, vals = _random_ctx(rng, (9, 7, 5), 80, values=True)
    chunks = [tuples[:30], tuples[30:31], tuples[31:]]
    vchunks = [vals[:30], vals[30:31], vals[31:]]
    tm = NOACMiner((9, 7, 5), delta=50.0, device="cpu")
    _leaves_equal(tm(tuples, vals),
                  tm.mine_chunked(chunks, values=vchunks, chunk_budget=7))
    # a key wider than 64 bits keeps no runs: one device sort of the
    # assembled table (with the value-lane pruning of __call__)
    big = (1 << 20, 1 << 20, 1 << 20, 1 << 20)
    rows = np.stack([rng.integers(0, 64, 40, dtype=np.int32)
                     for _ in big], 1)
    bm = BatchMiner(big, device="cpu")
    assert not bm.key_plans[0].fits
    assert_results_identical(JBatch(big).mine_chunked(rows, chunk_budget=9),
                             bm.mine_chunked(rows, chunk_budget=9))


def test_engine_registry_budgets():
    sizes = (9, 7, 5)
    rng = np.random.default_rng(13)
    tuples, vals = _random_ctx(rng, sizes, 160, values=True)
    for variant, v in (("prime", None), ("noac", vals)):
        kw = {} if variant == "prime" else {"delta": 2.0}
        ctx = PolyadicContext(sizes, tuples, v)
        mono = mine(ctx, backend="batch", variant=variant, device="cpu",
                    **kw)
        for budget in ("window_budget", "chunk_budget"):
            run = mine(ctx, backend="batch", variant=variant, device="cpu",
                       **{budget: 23}, **kw)
            _leaves_equal(mono.result, run.result)
            assert mono.n_clusters == run.n_clusters > 0
            _leaves_equal(run.result, run.rerun())


def test_miner_window_budget_is_the_default():
    rng = np.random.default_rng(17)
    tuples, _ = _random_ctx(rng, (6, 5, 4), 70, values=False)
    bm = BatchMiner((6, 5, 4), window_budget=9, device="cpu")
    assert bm.window_budget == 9
    probe = MP.MemProbe("cpu")
    got = bm.mine_windowed(tuples, probe=probe)
    _leaves_equal(bm(tuples), got)
    assert len(probe.stages) == 3


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [0, -3])
def test_degenerate_budgets_raise(budget):
    rng = np.random.default_rng(29)
    tuples, _ = _random_ctx(rng, (4, 3, 3), 20, values=False)
    bm = BatchMiner((4, 3, 3), device="cpu")
    with pytest.raises(ValueError, match="window_budget"):
        bm.mine_windowed(tuples, window_budget=budget)
    with pytest.raises(ValueError, match="chunk_budget"):
        bm.mine_chunked(tuples, chunk_budget=budget)
    with pytest.raises(ValueError, match="window_budget"):
        RX.plan_windows(20, budget)


def test_windowed_rejects_lexsort_wide_keys_and_pruned_lanes():
    rng = np.random.default_rng(31)
    tuples, _ = _random_ctx(rng, (4, 3, 3), 20, values=False)
    with pytest.raises(ValueError, match="lexsort"):
        BatchMiner((4, 3, 3), packed=False,
                   device="cpu").mine_windowed(tuples, window_budget=5)
    big = (1 << 20, 1 << 20, 1 << 20, 1 << 20)
    rows = np.stack([rng.integers(0, 64, 10, dtype=np.int32)
                     for _ in big], 1)
    with pytest.raises(ValueError, match="64"):
        BatchMiner(big, device="cpu").mine_windowed(rows, window_budget=5)
    lo, hi = TP.hash_vectors_from_numpy(TP.mode_hash_vectors((4, 3, 3)),
                                        "cpu")
    perms = np.stack([np.arange(20, dtype=np.int32)] * 3)
    vals = np.zeros(20, np.float32)
    kw = dict(hash_lo=lo, hash_hi=hi, window_budget=4, device="cpu")
    with pytest.raises(ValueError, match="64"):
        WD.mine_windowed(rows, None,
                         np.stack([np.arange(10, dtype=np.int32)] * 4),
                         plans=TP.K.plan_context_keys(big, False), **kw)
    with pytest.raises(ValueError, match="sort_backend"):
        WD.mine_windowed(tuples, None, perms,
                         plans=TP.K.plan_context_keys((4, 3, 3), False),
                         sort_backend="lexsort", **kw)
    with pytest.raises(ValueError, match="un-pruned"):
        WD.mine_windowed(tuples, vals, perms, delta=1.0,
                         plans=TP.K.plan_context_keys((4, 3, 3), True, 1),
                         **kw)
    with pytest.raises(ValueError, match="delta"):
        WD.mine_windowed(tuples, vals, perms, delta=-1.0,
                         plans=TP.K.plan_context_keys((4, 3, 3), True), **kw)
    with pytest.raises(ValueError, match="perms shape"):
        WD.mine_windowed(tuples, None, perms[:, :5],
                         plans=TP.K.plan_context_keys((4, 3, 3), False),
                         **kw)


# ---------------------------------------------------------------------------
# core.memprobe, CPU half
# ---------------------------------------------------------------------------

def test_memprobe_cpu():
    base = MP.device_bytes("cpu")
    assert base > 0
    probe = MP.MemProbe("cpu")
    blob = np.ones(64 << 20, np.uint8)          # 64 MiB touched
    assert probe("a") >= 0 and blob.sum() == 64 << 20
    probe("b")
    rep = probe.report()
    assert rep["peak_bytes"] == max(rep["stages"].values())
    assert list(rep["stages"]) == ["a", "b"]
    res = BatchMiner((4, 3, 3), device="cpu")(
        np.array([[0, 1, 2], [1, 2, 0]], np.int32))
    assert MP.measure_result_bytes(res) == 0       # host leaves
    with pytest.raises(ValueError, match="no allocation probe"):
        MP.device_bytes("meta")


def test_memprobe_never_reports_rss_for_cuda():
    if torch.cuda.is_available():
        assert MP.device_bytes("cuda") == torch.cuda.memory_allocated()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            MP.device_bytes("cuda")
