"""Parity of the port's streaming engine (``repro_torch.core.streaming``)
with the JAX package's: snapshots bit-identical leaf for leaf (padding
included) at every chunk, for prime and NOAC, over add / upsert / delete
streams, the non-incremental path of a key wider than 64 bits,
``full_remine=True`` and windowed snapshots; the stream and dirty-
signature counters; snapshots after a checkpoint written by either
package; and the registry, ``make_miner`` and the CLI on the streaming
backend and the batch budgets."""
import re

import numpy as np
import pytest
import torch

from _torch_parity import apply_op, assert_results_identical, gen_ops
from repro.core import StreamingMiner as JStream
from repro.core import make_miner as jmake_miner
from repro.core import mine as jmine
from repro.core import runs as JR
from repro.data import synthetic as JS
from repro.launch import tricluster as jcli
from repro_torch.core import BatchMiner, NOACMiner, StreamingMiner
from repro_torch.core import make_miner, mine
from repro_torch.core import runs as TR
from repro_torch.core.streaming import StreamState
from repro_torch.data import synthetic as TS
from repro_torch.launch import tricluster as tcli

SIZES = (7, 6, 5)
DELTA = 50.0


def _pair(valued, **kw):
    kw = dict(kw, delta=DELTA) if valued else kw
    return JStream(SIZES, **kw), StreamingMiner(SIZES, device="cpu", **kw)


@pytest.mark.parametrize("valued", [False, True])
@pytest.mark.parametrize("backend", [None, "lax"])
def test_snapshots_at_every_chunk(valued, backend):
    ctx = TS.random_context(SIZES, 150, seed=4, values=valued)
    if valued:
        ctx = ctx.deduplicated()
    j, t = _pair(valued, sort_backend=backend)
    for lo in range(0, ctx.num_tuples, 37):
        chunk = ctx.tuples[lo:lo + 37]
        vals = None if ctx.values is None else ctx.values[lo:lo + 37]
        j.add(chunk, vals)
        t.add(chunk, vals)
        got = t.snapshot()
        assert got.sig_lo.shape[0] == TR.snapshot_cap(t.state.count)
        assert_results_identical(j.snapshot(), got)
    assert t.stats == j.stats
    assert t.stats["incremental"] is True
    assert t.stream_version == j.stream_version == t.snapshot_stream_version


@pytest.mark.parametrize("valued", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_upsert_delete_streams(seed, valued):
    rng = np.random.default_rng(seed)
    j, t = _pair(valued)
    j.track_dirty_sigs = t.track_dirty_sigs = True
    for i, op in enumerate(gen_ops(rng, SIZES, 12, valued)):
        apply_op(j, op)
        apply_op(t, op)
        if i % 3 != 2 or t.state is None or t.state.count == 0:
            continue
        if t.state.alive[:t.state.count].sum() == 0:
            for m in (j, t):
                with pytest.raises(ValueError, match="no live rows"):
                    m.snapshot()
            continue
        assert_results_identical(j.snapshot(), t.snapshot())
        assert t.last_dirty_sigs == j.last_dirty_sigs
        np.testing.assert_array_equal(t.last_kept_sigs, j.last_kept_sigs)
        assert_results_identical(j.snapshot(full_remine=True),
                                 t.snapshot(full_remine=True))
    assert t.stats == j.stats
    assert t.stream_version == j.stream_version == 12


def test_wide_key_streams_without_runs():
    """A key wider than 64 bits: every snapshot re-sorts on the device
    (the lexsort path), and upsert/delete still work."""
    big = (1 << 20, 1 << 20, 1 << 20, 1 << 20)
    rng = np.random.default_rng(6)
    rows = np.stack([rng.integers(0, 40, 60, dtype=np.int32)
                     for _ in big], 1)
    j = JStream(big)
    t = StreamingMiner(big, device="cpu")
    assert t.stats["incremental"] is False is j.stats["incremental"]
    for m in (j, t):
        m.add(rows[:30])
        m.add(rows[30:])
        m.upsert(rows[:4])
        m.delete(rows[10:14])
    got = t.snapshot()
    assert_results_identical(j.snapshot(), got)
    assert t.stats["full_resorts"] == 1 and t.state.runs == []
    assert_results_identical(j.snapshot(full_remine=True),
                             t.snapshot(full_remine=True))


@pytest.mark.parametrize("budget", [1, 7, 31, 1000])
def test_windowed_snapshot(budget):
    ctx = TS.random_context(SIZES, 150, seed=17, values=True).deduplicated()
    j = JStream(SIZES, delta=3.0, window_budget=budget)
    t = StreamingMiner(SIZES, delta=3.0, window_budget=budget, device="cpu")
    ref = StreamingMiner(SIZES, delta=3.0, device="cpu")
    for m in (j, t, ref):
        for lo in range(0, ctx.num_tuples, 50):
            m.add(ctx.tuples[lo:lo + 50], ctx.values[lo:lo + 50])
        m.delete(ctx.tuples[:5])
    got = t.snapshot()
    assert got.keep.device.type == "cpu"
    assert_results_identical(j.snapshot(), got)
    want = ref.snapshot()
    for name in want.__dataclass_fields__:
        assert torch.equal(getattr(want, name), getattr(got, name)), name


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("valued", [False, True])
def test_snapshot_after_checkpoint(tmp_path, writer, legacy, valued):
    rng = np.random.default_rng(21)
    ops = gen_ops(rng, SIZES, 10, valued)
    cut = 6
    j, t = _pair(valued)
    whole = StreamingMiner(SIZES, device="cpu",
                           **({"delta": DELTA} if valued else {}))
    for op in ops[:cut]:
        apply_op(j if writer == "jax" else t, op)
    for op in ops:
        apply_op(whole, op)
    src = j if writer == "jax" else t
    blob = src.state.checkpoint()
    if legacy:
        blob = {k: blob[k] for k in ("buffer", "count", "values")
                if k in blob}
        blob["runs"] = []
    path = str(tmp_path / "stream.ckpt")
    (JR if writer == "jax" else TR).save_checkpoint(
        blob, path, meta={"stream_version": src.stream_version})
    for pkg, miner in ((TR, StreamingMiner), (JR, JStream)):
        loaded, meta = pkg.load_checkpoint(path)
        assert meta["stream_version"] == cut
        kw = {"delta": DELTA} if valued else {}
        resumed = (miner(SIZES, device="cpu", **kw) if miner is StreamingMiner
                   else miner(SIZES, **kw))
        resumed.state = pkg.RunStore.restore(loaded)
        if legacy:
            assert resumed.state.covered == 0
        for op in ops[cut:]:
            apply_op(resumed, op)
        assert_results_identical(resumed.snapshot(), whole.snapshot())


def test_stream_state_alias_and_restore():
    assert StreamState is TR.RunStore
    ctx = TS.random_context((6, 6, 6), 64, seed=2)
    sm = StreamingMiner(ctx.sizes, device="cpu")
    sm.add(ctx.tuples[:32])
    sm2 = StreamingMiner(ctx.sizes, device="cpu")
    sm2.state = StreamState.restore({"buffer": ctx.tuples[:32].copy(),
                                     "count": 32})
    sm2.add(ctx.tuples[32:])
    assert sm2.stats["chunk_sorted_rows"] == 64      # one lazy rebuild
    full = BatchMiner(ctx.sizes, device="cpu")(ctx.tuples)
    got = sm2.snapshot()
    assert int(got.keep.sum()) == int(full.keep.sum())
    with pytest.raises(ValueError, match="no data"):
        StreamingMiner(ctx.sizes, device="cpu").snapshot()


# ---------------------------------------------------------------------------
# Registry, make_miner, CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random_prime", "movielens_noac"])
@pytest.mark.parametrize("chunks", [1, 4])
def test_mine_streaming_backend(case, chunks):
    make = {"random_prime": lambda S: (S.random_context((9, 8, 7), 300,
                                                        seed=12), {}),
            "movielens_noac": lambda S: (S.movielens_like(n_tuples=800),
                                         {"delta": 1.0})}[case]
    (jctx, params), (tctx, _) = make(JS), make(TS)
    variant = "noac" if "delta" in params else "prime"
    want = jmine(jctx, backend="streaming", variant=variant, chunks=chunks,
                 **params)
    got = mine(tctx, backend="streaming", variant=variant, chunks=chunks,
               device="cpu", **params)
    assert got.n_clusters == want.n_clusters > 0
    assert_results_identical(want.result, got.result)
    assert isinstance(got.miner, StreamingMiner)
    assert_results_identical(want.result, got.rerun())
    batch = mine(tctx, backend="batch", variant=variant, device="cpu",
                 **params)
    assert batch.n_clusters == got.n_clusters


def test_make_miner_streaming():
    ctx = TS.random_context((6, 5, 4), 90, seed=3)
    got = make_miner(ctx.sizes, backend="streaming", device="cpu")
    want = jmake_miner(ctx.sizes, backend="streaming")
    assert isinstance(got, StreamingMiner)
    got.add(ctx.tuples)
    want.add(ctx.tuples)
    assert_results_identical(want.snapshot(), got.snapshot())
    m = make_miner((6, 5, 4), backend="streaming", delta=1.0, rho_min=0.1,
                   minsup=1, incremental=False, device="cpu")
    assert isinstance(m, StreamingMiner) and not isinstance(m, NOACMiner)
    assert m.delta == 1.0 and m.theta == 0.1 and not m.incremental


def _count(out):
    m = re.search(r": (\d+) (unique clusters|triclusters)", out)
    assert m, out
    return int(m.group(1))


@pytest.mark.parametrize("args", [
    ["--backend", "streaming", "--chunks", "4"],
    ["--backend", "streaming", "--chunks", "3", "--no-incremental"],
    ["--backend", "streaming", "--chunks", "2", "--window-budget", "100"],
    ["--backend", "batch", "--chunk-budget", "100"],
    ["--backend", "batch", "--window-budget", "77"],
    ["--backend", "streaming", "--chunks", "4", "--delta", "1.0",
     "--dataset", "movielens"],
])
def test_cli_streaming_and_budgets(capsys, args):
    base = ["--dataset", "random", "--n-tuples", "512", "--print-top", "0"]
    if "--dataset" in args:
        base = ["--n-tuples", "512", "--print-top", "0"]
    assert jcli.main(base + args) == 0
    want = _count(capsys.readouterr().out)
    assert tcli.main(base + args + ["--device", "cpu"]) == 0
    got = _count(capsys.readouterr().out)
    assert got == want > 0
