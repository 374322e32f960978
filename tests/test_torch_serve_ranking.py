"""Parity of the port's ranking layer (``repro_torch.serve.ranking``) with
``repro.serve.ranking`` on the CPU: the same index gives the same scores
float for float under every policy term, the same scalar, batched and
raw top-k hits, the same global top-k, signature lookups and packed
words.  Modelled on ``tests/test_serve_ranking.py``."""
import numpy as np
import pytest

from _torch_parity import hits_view
from repro.core import BatchMiner as JBatch
from repro.data import synthetic as JS
from repro.serve import clusters as JC
from repro.serve import ranking as JR
from repro_torch.core import BatchMiner, StreamingMiner
from repro_torch.data import synthetic as TS
from repro_torch.serve import clusters as TC
from repro_torch.serve import ranking as TR

POLICIES = [(), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0), (0.5, 0.3, 0.2)]


@pytest.fixture(scope="module")
def mined():
    jctx = JS.random_context((8, 7, 6), 96, seed=7)
    ctx = TS.random_context((8, 7, 6), 96, seed=7)
    jidx = JC.ClusterIndex.from_result(JBatch(jctx.sizes)(jctx.tuples))
    res = BatchMiner(ctx.sizes, device="cpu")(ctx.tuples)
    return ctx, jidx, TC.ClusterIndex.from_result(res)


@pytest.mark.parametrize("weights", POLICIES)
def test_scores_and_hits_equal_jax(mined, weights):
    ctx, jidx, tidx = mined
    n = len(tidx)
    ages = np.arange(n, dtype=np.float64) % 5
    jq = JR.BatchQuerier(jidx, JR.RankingPolicy(*weights), ages)
    tq = TR.BatchQuerier(tidx, TR.RankingPolicy(*weights), ages)
    assert tq.scores.dtype == np.float64
    np.testing.assert_array_equal(tq.scores, jq.scores)
    np.testing.assert_array_equal(
        TR.cluster_scores(tidx, TR.RankingPolicy(*weights), ages),
        JR.cluster_scores(jidx, JR.RankingPolicy(*weights), ages))
    rng = np.random.default_rng(len(weights))
    for mode in (None, 0, 1, 2):
        # includes out-of-vocabulary entities (no hits) on purpose
        ents = rng.integers(-1, ctx.sizes[mode or 0] + 3, 40).tolist()
        for e in ents[:10]:
            assert hits_view(tq.topk(e, mode, 4)) == \
                hits_view(jq.topk(e, mode, 4))
        batch = tq.topk_batch(ents, mode, 4)
        assert [hits_view(h) for h in batch] == \
            [hits_view(h) for h in jq.topk_batch(ents, mode, 4)]
        for e, got in zip(ents, batch):
            assert [(id(v), s) for v, s in got] == \
                [(id(v), s) for v, s in tq.topk(e, mode, 4)]
        for g, w in zip(tq.topk_batch_raw(ents, mode, 4),
                        jq.topk_batch_raw(ents, mode, 4)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert hits_view(TR.top_from_scores(tidx, tq.scores, 7)) == \
        hits_view(JR.top_from_scores(jidx, jq.scores, 7))
    assert hits_view(TR.top_clusters(tidx, 7, TR.RankingPolicy(*weights),
                                     ages)) == \
        hits_view(JR.top_clusters(jidx, 7, JR.RankingPolicy(*weights),
                                  ages))
    with pytest.raises(ValueError):
        tq.topk_batch([0], mode=7)


def test_signature_lookup_and_packing_equal_jax(mined):
    ctx, jidx, tidx = mined
    jq, tq = JR.BatchQuerier(jidx), TR.BatchQuerier(tidx)
    # streaming-issued signatures resolve against the batch index
    sm = StreamingMiner(ctx.sizes, device="cpu")
    sm.add(ctx.tuples[:48])
    sm.add(ctx.tuples[48:])
    sidx = TC.ClusterIndex.from_result(sm.snapshot())
    sigs = [c.signature for c in sidx.clusters[:8]] + [(0, 0),
                                                      (2**32 - 1, 7)]
    rows = tq.lookup_signatures(sigs)
    np.testing.assert_array_equal(rows, jq.lookup_signatures(sigs))
    assert rows[-1] == rows[-2] == -1 and (rows[:-2] >= 0).all()
    for sig, row in zip(sigs[:-2], rows[:-2]):
        assert tidx.clusters[row].signature == sig
    lo, hi = [1, 0xFFFFFFFF, 2**31], [2, 3, 0xFFFFFFFF]
    np.testing.assert_array_equal(TR.pack_signatures(lo, hi),
                                  JR.pack_signatures(lo, hi))
    assert int(TR.pack_signatures(lo, hi)[1]) == (3 << 32) | 0xFFFFFFFF
    # a plain-list index (no packed words) resolves through its argsort
    plain_t = TC.ClusterIndex(list(tidx.clusters))
    plain_j = JC.ClusterIndex(list(jidx.clusters))
    np.testing.assert_array_equal(
        TR.BatchQuerier(plain_t).lookup_signatures(sigs),
        JR.BatchQuerier(plain_j).lookup_signatures(sigs))


def test_rank_views_stable_on_ties():
    hits = [("a", 1.0), ("b", 2.0), ("c", 1.0)]
    assert TR.rank_views(hits) == JR.rank_views(hits) == [
        ("b", 2.0), ("a", 1.0), ("c", 1.0)]
    assert TR.rank_views(hits, k=1) == [("b", 2.0)]


def test_serve_exports():
    import repro_torch.serve as S
    for name in ("TriclusterService", "Snapshot", "QueryResult",
                 "BatchQuerier", "RankingPolicy", "top_clusters",
                 "ClusterIndex", "cluster_query", "FaultPlan",
                 "ServeEngine"):
        assert hasattr(S, name) and name in S.__all__, name
