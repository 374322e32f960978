"""Parity of the port's cluster-query index (``repro_torch.serve.clusters``)
with ``repro.serve.clusters`` on the CPU: the index built from the port's
result equals the JAX package's index of the JAX result array for array
(batch prime, NOAC, a streaming snapshot and a windowed result with host
leaves); the delta index equals JAX's delta and the full rebuild along a
seeded write stream; queries answer alike; signatures with their top bit
set pack and read back as JAX's; and the readback takes the ten leaves
an index needs, once.  Modelled on ``tests/test_serve_clusters.py``."""
import types

import numpy as np
import pytest
import torch

from _torch_parity import apply_op, assert_index_identical, gen_ops
from repro.core import BatchMiner as JBatch
from repro.core import NOACMiner as JNOAC
from repro.core import StreamingMiner as JStream
from repro.data import synthetic as JS
from repro.serve import clusters as JC
from repro_torch.core import (BatchMiner, DistributedMiner, NOACMiner,
                              StreamingMiner)
from repro_torch.core.postprocess import cluster_set
from repro_torch.data import synthetic as TS
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serve import clusters as TC


def _results(kind):
    """(JAX result, port result) of one small context."""
    if kind in ("prime", "windowed"):
        jctx = JS.random_context((8, 7, 6), 96, seed=7)
        tctx = TS.random_context((8, 7, 6), 96, seed=7)
        if kind == "prime":
            return (JBatch(jctx.sizes)(jctx.tuples),
                    BatchMiner(tctx.sizes, device="cpu")(tctx.tuples))
        return (JBatch(jctx.sizes).mine_windowed(jctx.tuples,
                                                  window_budget=29),
                BatchMiner(tctx.sizes, device="cpu").mine_windowed(
                    tctx.tuples, window_budget=29))
    if kind == "noac":
        jctx = JS.random_context((8, 7, 6), 120, seed=9,
                                 values=True).deduplicated()
        tctx = TS.random_context((8, 7, 6), 120, seed=9,
                                 values=True).deduplicated()
        return (JNOAC(jctx.sizes, delta=40.0)(jctx.tuples, jctx.values),
                NOACMiner(tctx.sizes, delta=40.0, device="cpu")(
                    tctx.tuples, tctx.values))
    jctx = JS.random_context((9, 8, 7), 160, seed=8)
    jm, tm = JStream(jctx.sizes), StreamingMiner(jctx.sizes, device="cpu")
    for m in (jm, tm):
        m.add(jctx.tuples[:70])
        m.add(jctx.tuples[70:])
        m.delete(jctx.tuples[:9])
    return jm.snapshot(), tm.snapshot()


@pytest.fixture(scope="module", params=["prime", "noac", "streaming",
                                        "windowed"])
def pair(request):
    return request.param, _results(request.param)


def test_full_index_identical_to_jax(pair):
    kind, (jres, tres) = pair
    if kind == "windowed":
        assert tres.keep.device.type == "cpu"     # host leaves
    for kw in ({}, {"only_kept": False}, {"min_density": 0.3}):
        want = JC.ClusterIndex.from_result(jres, **kw)
        got = TC.ClusterIndex.from_result(tres, **kw)
        assert_index_identical(want, got, f"{kind} {kw}")
        assert got.signature_keys() == want.signature_keys()
    idx = TC.ClusterIndex.from_result(tres)
    want = cluster_set(BatchMiner.materialise(None, tres))
    assert {tuple(tuple(sorted(c)) for c in cv.components)
            for cv in idx} == want and len(idx) == len(want)


def test_queries_match_jax(pair):
    kind, (jres, tres) = pair
    jidx = JC.ClusterIndex.from_result(jres)
    tidx = TC.ClusterIndex.from_result(tres)
    ents = np.unique(TC.leaf(tres, "sorted_e")[:, :12])
    for e in ents.tolist() + [10_000, -1]:
        for mode in (None, 0, 1, 2):
            np.testing.assert_array_equal(tidx.entity_rows(e, mode),
                                          jidx.entity_rows(e, mode))
            assert [c.signature for c in tidx.query(entity=e, mode=mode)] \
                == [c.signature for c in jidx.query(entity=e, mode=mode)]
    for c in list(jidx)[:6]:
        (got,) = tidx.query(signature=c.signature)
        assert got.signature == c.signature and got.density == c.density
        assert tuple(got.components) == tuple(c.components)
    assert tidx.query(signature=(0, 0)) == []
    assert [c.signature for c in tidx.query(min_density=0.5)] == \
        [c.signature for c in jidx.query(min_density=0.5)]
    with pytest.raises(ValueError):
        tidx.query(entity=1, mode=5)
    e = int(ents[0])
    for kw in ({"entity": e, "mode": 0}, {}):
        got = TC.cluster_query(tres, **kw)
        want = JC.cluster_query(jres, **kw)
        assert [(v.signature, v.density) for v in got] == \
            [(v.signature, v.density) for v in want]
    flat = TC.ClusterIndex.from_arrays(
        tidx.packed_sigs, tidx.mode_pairs, tidx.comp_ents,
        tidx.comp_bounds, tidx.any_pairs, tidx.density, tidx.gen_count,
        tidx.volume)
    jflat = JC.ClusterIndex.from_arrays(
        jidx.packed_sigs, jidx.mode_pairs, jidx.comp_ents,
        jidx.comp_bounds, jidx.any_pairs, jidx.density, jidx.gen_count,
        jidx.volume)
    assert [v.signature for v in flat] == [v.signature for v in jflat]


@pytest.mark.parametrize("valued", [False, True])
def test_delta_index_equals_jax_delta_and_full_rebuild(valued):
    """A seeded add / upsert / delete stream through both packages'
    streaming miners: at every snapshot the port's delta index (chained
    on its previous one) answers entity probes as JAX's delta does before
    materialising, and materialises to JAX's arrays and to the port's own
    full rebuild."""
    sizes = (9, 8, 7)
    kw = {"delta": 30.0} if valued else {}
    jm, tm = JStream(sizes, **kw), StreamingMiner(sizes, device="cpu", **kw)
    rng = np.random.default_rng(21 + valued)
    base = np.stack([rng.integers(0, s, 150) for s in sizes],
                    1).astype(np.int32)
    vals = (rng.uniform(0.0, 100.0, 150).astype(np.float32) if valued
            else None)
    stream = [("add", base, vals)] + gen_ops(rng, sizes, 8, valued,
                                             max_chunk=4)
    jprev = tprev = None
    overlays = 0
    for i, op in enumerate(stream):
        for m in (jm, tm):
            apply_op(m, op)
        if jm.state.count - jm.state.dead == 0:
            continue
        jres, tres = jm.snapshot(), tm.snapshot()
        if tprev is None:
            jidx = JC.ClusterIndex.from_result(jres)
            tidx = TC.ClusterIndex.from_result(tres)
        else:
            jidx = JC.ClusterIndex.delta_from_result(jprev, jres)
            tidx = TC.ClusterIndex.delta_from_result(tprev, tres)
        overlays += tidx._base is not None
        assert (tidx._base is None) == (jidx._base is None), i
        for e in range(8):
            for mode in (None, 1):
                np.testing.assert_array_equal(tidx.entity_rows(e, mode),
                                              jidx.entity_rows(e, mode))
        full = TC.ClusterIndex.from_result(tres)
        if i % 2:        # materialise every other index (a new base)
            assert_index_identical(full, tidx, f"op {i} delta vs full")
            assert_index_identical(jidx, tidx, f"op {i} vs JAX delta")
        jprev, tprev = jidx, tidx
    assert overlays >= 4


def test_top_bit_signatures_pack_as_jax():
    """An int32 signature lane with its top bit set: packed directly and
    through the readback, it gives JAX's uint64 word and positive ints."""
    lo = np.array([-1, -(1 << 31), 5, 0x7FFFFFFF], np.int32)
    hi = np.array([3, -2, -(1 << 31), -1], np.int32)
    want = JC.pack_sig_words(lo.view(np.uint32), hi.view(np.uint32))
    np.testing.assert_array_equal(TC.pack_sig_words(lo, hi), want)
    res = types.SimpleNamespace(sig_lo=torch.from_numpy(lo),
                                sig_hi=torch.from_numpy(hi))
    got_lo, got_hi = TC.leaf(res, "sig_lo"), TC.leaf(res, "sig_hi")
    assert got_lo.dtype == np.uint32
    np.testing.assert_array_equal(TC.pack_sig_words(got_lo, got_hi), want)
    assert int(got_lo[0]) == 0xFFFFFFFF and int(got_hi[1]) == 0xFFFFFFFE
    # a real result: about half its signatures have the top bit set
    jres, tres = _results("prime")
    tidx = TC.ClusterIndex.from_result(tres)
    jidx = JC.ClusterIndex.from_result(jres)
    assert (tidx.sig_lo >= 1 << 31).any() and (tidx.sig_hi >= 1 << 31).any()
    assert [c.signature for c in tidx] == [c.signature for c in jidx]
    assert all(a >= 0 and b >= 0 for a, b in tidx.signature_keys())


def test_readback_takes_the_index_leaves_once():
    """``host_result`` reads the ten leaves an index needs, never
    ``cardinalities`` or ``perms``; a ``HostResult`` passes through; a
    result without component windows raises."""
    _, tres = _results("prime")
    reads = []

    class Counting:
        def __getattr__(self, name):
            if name in ("cardinalities", "perms"):
                raise AssertionError(f"read {name}")
            reads.append(name)
            return getattr(tres, name)

    host = TC.host_result(Counting())
    assert set(reads) == set(TC.INDEX_LEAVES)
    assert TC.host_result(host) is host
    assert host.nbytes == sum(TC.leaf(tres, n).nbytes
                              for n in TC.INDEX_LEAVES)
    assert host.sig_lo.dtype == np.uint32 and host.keep.dtype == bool
    assert_index_identical(TC.ClusterIndex.from_result(tres),
                           TC.ClusterIndex.from_result(host))
    ctx = TS.random_context((8, 7, 6), 96, seed=7)
    dres = DistributedMiner(ctx.sizes, make_local_mesh(device="cpu"))(
        ctx.tuples)
    with pytest.raises(ValueError, match="component windows"):
        TC.ClusterIndex.from_result(dres)
