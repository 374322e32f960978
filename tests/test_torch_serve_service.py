"""Parity of the port's cluster service (``repro_torch.serve.service``)
with ``repro.serve.service`` on the CPU: the same write stream, with
explicit ``refresh()`` and no timing dependence, gives the same versions,
stream versions, packed signature words, scores, ages, top-k hits and
``stats()`` keys; every delta-maintained index equals the full rebuild;
the distributed backend serves the streaming backend's clusters; the obs
hub fills JAX's service series; and the lifecycle, freshness and
concurrent-reader guarantees hold.  Modelled on
``tests/test_serve_service.py``.  The card twin is
``tests/test_torch_cuda.py::test_service_on_the_card_equals_the_cpu``."""
import threading
import time

import numpy as np
import pytest

import repro.obs as JO
import repro_torch.obs as TO
from _torch_parity import assert_index_identical, gen_ops, hits_view
from repro.serve.service import TriclusterService as JService
from repro_torch.core import BatchMiner
from repro_torch.data import synthetic as TS
from repro_torch.serve.clusters import ClusterIndex
from repro_torch.serve.service import TriclusterService

SIZES = (9, 8, 7)
QUIET = dict(refresh_interval=3600.0, dirty_threshold=10**9,
             scrub_interval=0.0)


def _stream(seed, valued, n_ops=8):
    rng = np.random.default_rng(seed)
    base = np.stack([rng.integers(0, s, 150) for s in SIZES],
                    1).astype(np.int32)
    vals = rng.uniform(0, 100, 150).astype(np.float32) if valued else None
    return [("add", base, vals)] + gen_ops(rng, SIZES, n_ops, valued,
                                           max_chunk=5)


def _write(svc, op):
    kind, rows, vals = op
    if kind == "delete":
        return svc.delete(rows)
    return getattr(svc, kind)(rows, vals)


def _served(snap, svc, ents):
    return (snap.version, snap.stream_version, snap.index.packed_sigs,
            snap.querier.scores, snap.ages,
            hits_view(svc.query(k=6).hits),
            [hits_view(h) for h in svc.query_batch(ents, mode=1, k=4).hits],
            hits_view(svc.query(entity=int(ents[0]), k=5).hits))


@pytest.mark.parametrize("valued,delta_index", [
    (False, True), (True, True), (False, False)])
def test_write_stream_matches_jax(valued, delta_index):
    kw = dict(QUIET, seed=11, delta_index=delta_index,
              **({"delta": 30.0} if valued else {}))
    jsvc, tsvc = JService(SIZES, **kw), TriclusterService(SIZES,
                                                          device="cpu", **kw)
    ents = np.arange(-1, 10)
    for i, op in enumerate(_stream(5 + valued, valued)):
        assert _write(tsvc, op) == _write(jsvc, op)
        if i % 3 == 1:
            continue                  # two writes under one snapshot
        got, want = tsvc.refresh(), jsvc.refresh()
        g, w = _served(got, tsvc, ents), _served(want, jsvc, ents)
        assert g[:2] == w[:2]
        for a, b in zip(g[2:5], w[2:5]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g[5:] == w[5:]
        assert_index_identical(ClusterIndex.from_result(got.result),
                               got.index, f"version {got.version}")
        for sig, _, _ in g[5][:3]:
            assert hits_view(tsvc.query(signature=sig).hits) == \
                hits_view(jsvc.query(signature=sig).hits)
    ts, js = tsvc.stats(), jsvc.stats()
    assert sorted(ts) == sorted(js)
    for key in ("writes", "publishes", "delta_builds", "full_builds",
                "version", "stream_version", "clusters", "dirty",
                "dirty_clusters", "sizes"):
        assert ts[key] == js[key], key
    assert (ts["delta_builds"] > 0) == delta_index
    assert tsvc.resilience_stats().keys() == jsvc.resilience_stats().keys()


def test_obs_hub_fills_the_jax_service_series():
    jsvc = JService(SIZES, obs=JO.Obs.create(), **QUIET)
    tsvc = TriclusterService(SIZES, obs=TO.Obs.create(), device="cpu",
                             **QUIET)
    views = []
    for svc in (jsvc, tsvc):
        for op in _stream(3, False, n_ops=3):
            _write(svc, op)
            svc.refresh()
        svc.scrub()
        doc = svc.obs.metrics.to_dict()
        views.append({name: (ent["kind"], sorted(
            (repr(r["labels"]), r.get("count")) for r in ent["series"]))
            for name, ent in doc.items()})
        spans = svc.obs.tracer.spans()
        views.append(([s["name"] for s in spans],
                      [s["attrs"]["build"] for s in spans]))
    assert views[2] == views[0] and views[3] == views[1]
    assert views[2]["service_index_build_ms"][1] == [
        ("{'kind': 'delta'}", 3), ("{'kind': 'full'}", 1)]
    attrs = tsvc.obs.tracer.spans()[-1]["attrs"]
    assert attrs["readback_bytes"] > 0 and attrs["readback_ms"] >= 0
    text = tsvc.obs.metrics.expose()
    assert 'repro_service_publishes{role="writer"} 4.0' in text


def test_distributed_backend_serves_the_streaming_clusters():
    """``backend="distributed"`` (one rank, ``serving_snapshot``) against
    the streaming backend and JAX's distributed service, write for
    write."""
    tsvc = TriclusterService(SIZES, backend="distributed", device="cpu",
                             **QUIET)
    ssvc = TriclusterService(SIZES, device="cpu", **QUIET)
    jsvc = JService(SIZES, backend="distributed", **QUIET)
    assert tsvc.miner.track_dirty_sigs
    ents = np.arange(8)
    for op in _stream(9, False, n_ops=4):
        for svc in (tsvc, ssvc, jsvc):
            _write(svc, op)
        got, ref, want = tsvc.refresh(), ssvc.refresh(), jsvc.refresh()
        g = _served(got, tsvc, ents)
        for other, svc in ((ref, ssvc), (want, jsvc)):
            o = _served(other, svc, ents)
            assert g[:2] == o[:2] and g[5:] == o[5:]
            np.testing.assert_array_equal(g[2], o[2])
            np.testing.assert_array_equal(g[3], o[3])
    assert tsvc.dirty_clusters == jsvc.dirty_clusters


def test_lifecycle_and_freshness():
    ctx = TS.random_context((8, 7, 6), 96, seed=7)
    svc = TriclusterService(ctx.sizes, refresh_interval=0.01,
                            dirty_threshold=1, device="cpu")
    with pytest.raises(RuntimeError):
        svc.snapshot()
    with pytest.raises(ValueError):
        svc.refresh()                       # no data ingested yet
    svc.add(ctx.tuples)
    with svc:
        snap = svc.snapshot()
        assert snap.version == 1 and len(snap.index) > 0
        assert snap.stream_version == svc.miner.stream_version
        assert svc.refresh().version == 2    # advances even when clean
        assert svc.snapshot(at_least_version=2, timeout=1).version >= 2
        with pytest.raises(TimeoutError):
            svc.snapshot(at_least_version=99, timeout=0.05)
        svc.delete(ctx.tuples[:3])           # the thread re-mines it
        got = svc.snapshot(at_least_version=3, timeout=30)
        assert got.stream_version >= 2
        assert svc.thread_alive
        dead = {tuple(r) for r in ctx.tuples[:3].tolist()}
        survivors = np.asarray([r for r in ctx.tuples.tolist()
                                if tuple(r) not in dead], np.int32)
        bidx = ClusterIndex.from_result(
            BatchMiner(ctx.sizes, device="cpu")(survivors))
        assert {c.signature for c in bidx} == \
            {c.signature for c in got.index}
    assert svc.device.type == "cpu" and svc._thread is None


def test_concurrent_readers_only_see_complete_snapshots():
    """Readers under a live writer and the re-mine thread: versions never
    regress, and each snapshot's index holds exactly its own result's
    kept clusters."""
    ctx = TS.random_context((8, 7, 6), 96, seed=7)
    svc = TriclusterService(ctx.sizes, refresh_interval=0.01,
                            dirty_threshold=1, device="cpu")
    svc.add(ctx.tuples)
    errors, stop = [], threading.Event()

    def writer():
        rng = np.random.default_rng(1)
        while not stop.is_set():
            svc.upsert(ctx.tuples[rng.integers(0, 96, 3)])
            time.sleep(0.002)

    def reader():
        last = 0
        for _ in range(150):
            snap = svc.snapshot()
            if snap.version < last:
                errors.append(f"regressed {last}->{snap.version}")
            last = snap.version
            if len(snap.index) != int(snap.result.keep.sum()):
                errors.append(f"torn snapshot v{snap.version}")
            c = snap.index.view_at(0)
            if snap.index.query(signature=c.signature)[0] is not c:
                errors.append("signature did not resolve in its snapshot")

    with svc:
        threads = [threading.Thread(target=writer, daemon=True)] + [
            threading.Thread(target=reader, daemon=True) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads[1:]:
            t.join(timeout=60)
        stop.set()
        threads[0].join(timeout=10)
    assert not errors, errors[:5]
    assert svc.stats()["publishes"] >= 2
    assert svc.stats()["mine_errors"] == 0


def test_supervisor_events_wait_for_their_module(tmp_path):
    """``event_dir`` mirrors integrity events to ``serve.supervise``'s
    event file (the module is ported: nothing waits any more)."""
    svc = TriclusterService(SIZES, device="cpu", event_dir=str(tmp_path),
                            event_name="shard-3", **QUIET)
    svc._integrity_event("scrub_violation", "probe")
    assert svc.stats()["integrity_events"] == [["scrub_violation", "probe"]]
    with open(tmp_path / "shard-3.events") as fh:
        assert fh.read() == ('{"event": "scrub_violation", '
                             '"detail": "probe"}\n')
    svc.stop()
    with pytest.raises(ValueError, match="backend"):
        TriclusterService(SIZES, backend="spark", device="cpu")
