"""The port's sharded query router (``repro_torch.serve.router``).

Parity: a two-shard plane built in-process (writer threads, no spawn) in
each package over the same rows, split by each package's own
``core.runs.shard_of_rows``: the two routers answer scalar, batched,
top-k and signature queries, health and freshness tokens alike, and an
upsert spanning both shards lands in the same shards.  ``_merge_hits``
equals the JAX package's on random per-shard lists (ties and duplicate
signatures included) and on the case of ``tests/test_serve_scale.py``.
Twins, against the port: ``tests/test_serve_faults.py``'s
``TestRouterDegradation``."""
import threading
import time

import numpy as np
import pytest

from repro.core import keys as JK
from repro.core import runs as JRS
from repro.serve import router as JR
from repro.serve.protocol import make_server as jmake_server
from repro.serve.service import TriclusterService as JService
from repro_torch.core import keys as TK
from repro_torch.core import runs as TRS
from repro_torch.serve import router as TR
from repro_torch.serve.faults import Fault, FaultPlan
from repro_torch.serve.protocol import make_server
from repro_torch.serve.router import RouterService, Shard, _merge_hits
from repro_torch.serve.service import TriclusterService

SIZES = (24, 12, 8)
QUIET = dict(refresh_interval=3600.0, dirty_threshold=10**9,
             scrub_interval=0.0)


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{what} not reached in {timeout}s")
        time.sleep(0.01)


def _serve(svc, maker=make_server, **kw):
    server = maker(svc, port=0, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _hit(sig, score):
    return {"signature": list(sig), "score": score}


# -- _merge_hits --------------------------------------------------------------

def test_router_merge_ranks_dedups_truncates():
    a = [_hit((1, 0), 0.9), _hit((2, 0), 0.5), _hit((3, 0), 0.1)]
    b = [_hit((4, 0), 0.7), _hit((1, 0), 0.9), _hit((5, 0), 0.3)]
    merged = _merge_hits([a, b], k=4)
    assert [tuple(h["signature"]) for h in merged] \
        == [(1, 0), (4, 0), (2, 0), (5, 0)]
    scores = [h["score"] for h in merged]
    assert scores == sorted(scores, reverse=True)
    assert _merge_hits([[], []], k=3) == []
    assert merged == JR._merge_hits([a, b], k=4)


@pytest.mark.parametrize("seed", range(4))
def test_merge_hits_equals_jax(seed):
    rng = np.random.default_rng(seed)
    per = []
    for _ in range(int(rng.integers(1, 5))):
        n = int(rng.integers(0, 12))
        sc = np.sort(rng.choice([0.25, 0.5, 0.75, 1.0], n))[::-1]
        per.append([_hit((int(rng.integers(0, 9)), int(rng.integers(0, 2))),
                         float(s)) for s in sc])
    for k in (1, 3, 10, 100):
        assert _merge_hits(per, k) == JR._merge_hits(per, k)


# -- parity of two in-process planes ----------------------------------------

def _plane(pkg, rows):
    """Two writer shards over ``rows`` split by the package's own
    partitioner, served on threads, behind the package's router."""
    if pkg == "jax":
        Svc, maker, K, RS, R, kw = JService, jmake_server, JK, JRS, JR, {}
    else:
        Svc, maker, K, RS, R, kw = (TriclusterService, make_server, TK, TRS,
                                    TR, {"device": "cpu"})
    own = RS.shard_of_rows(rows, K.plan_mode_key(SIZES, 0,
                                                 with_values=False), 2)
    svcs, servers = [], []
    for s in range(2):
        svc = Svc(SIZES, seed=13, **QUIET, **kw)
        svc.add(rows[own == s])
        svcs.append(svc.start())
        servers.append(_serve(svc, maker))
    router = R.RouterService([R.Shard(f"http://127.0.0.1:{sv.port}")
                              for sv in servers], timeout=30.0)
    return own, svcs, servers, router


def _router_view(doc):
    return {k: v for k, v in doc.items() if k not in ("staleness_s",)}


def test_two_shard_routers_answer_alike():
    rows = np.random.default_rng(51).integers(0, SIZES, size=(400, 3))
    planes = [_plane(p, rows) for p in ("jax", "torch")]
    try:
        owns = [p[0] for p in planes]
        assert np.array_equal(owns[0], owns[1])
        assert 0 < int(owns[1].sum()) < rows.shape[0]   # both shards own

        def both(call):
            docs = [call(p[3]) for p in planes]
            assert docs[1] == docs[0]
            return docs[1]

        top = both(lambda r: r.query(k=9, include_components=True))
        assert len(top["hits"]) == 9 and top["coverage"] == [0, 1]
        both(lambda r: r.query(signature=top["hits"][4]["signature"]))
        both(lambda r: r.query(entity=int(rows[3, 1]), mode=1, k=6))
        both(lambda r: r.query_batch(list(range(SIZES[0])), mode=0, k=4,
                                     include_components=True))
        assert _router_view(planes[1][3].health()) \
            == _router_view(planes[0][3].health())
        # one write per shard: the same shards take it
        fresh = np.array([[1, 2, 3], [22, 11, 7], [5, 0, 6], [17, 9, 1]])
        up = both(lambda r: r.upsert(fresh.tolist()))
        assert up["shards"] == [0, 1]
        assert planes[1][3].shard_of(fresh).tolist() \
            == planes[0][3].shard_of(fresh).tolist()
        ref = both(lambda r: r.refresh())
        assert ref["shard_versions"] == [2, 2]
        both(lambda r: {k: v for k, v in r.query(
            entity=22, mode=0, k=5, include_components=True,
            at_least_version=ref["shard_versions"], timeout=30).items()
            if k != "server_ms"})
        both(lambda r: r.delete(fresh[:2].tolist()))
    finally:
        for _, svcs, servers, router in planes:
            router.close()
            for sv in servers:
                sv.shutdown()
                sv.server_close()
            for svc in svcs:
                svc.stop()


# -- twins of TestRouterDegradation -----------------------------------------

def _service(seed):
    rng = np.random.default_rng(seed)
    svc = TriclusterService(SIZES, refresh_interval=0.05, dirty_threshold=4,
                            seed=seed, device="cpu")
    svc.add(rng.integers(0, SIZES, size=(160, 3)).astype(np.int64))
    return svc.start()


def _degradation_plane(**router_kw):
    svcs = [_service(s) for s in (3, 4)]
    servers = [_serve(s) for s in svcs]
    shards = [Shard(f"http://127.0.0.1:{sv.port}", timeout=2.0)
              for sv in servers]
    return svcs, servers, RouterService(shards, timeout=2.0, **router_kw)


def test_shard_down_degrades_instead_of_502():
    svcs, servers, router = _degradation_plane()
    try:
        full = router.query(k=5)
        assert not full["degraded"] and full["coverage"] == [0, 1]
        servers[1].shutdown()
        servers[1].server_close()
        deg = router.query(k=5, timeout=1.0)
        assert deg["degraded"] and deg["coverage"] == [0]
        assert deg["shard_versions"][1] == 0
        local = [(int(v.signature[0]), int(v.signature[1]))
                 for v, _ in svcs[0].query(k=5).hits]
        assert [tuple(h["signature"]) for h in deg["hits"]] == local
        degb = router.query_batch([0, 1], k=3, timeout=1.0)
        assert degb["degraded"] and len(degb["hits"]) == 2
        with pytest.raises((RuntimeError, OSError, TimeoutError)):
            router.query(k=5, timeout=1.0, require_all=True)
        h = router.health()
        assert h["degraded"] and len(h["down"]) == 1
        assert h["coverage"] == [0]
    finally:
        router.close()
        for sv in servers:
            sv.shutdown()
            sv.server_close()
        for s in svcs:
            s.stop()


def test_every_shard_down_is_an_error():
    svcs, servers, router = _degradation_plane()
    try:
        for sv in servers:
            sv.shutdown()
            sv.server_close()
        with pytest.raises(RuntimeError, match="unreachable"):
            router.query(k=3, timeout=0.5)
    finally:
        router.close()
        for s in svcs:
            s.stop()


def test_hung_replica_circuit_breaks_then_reprobes():
    svc = _service(5)
    writer_srv = _serve(svc)
    plan = FaultPlan.build(Fault("hang", "request", role="replica", at=1,
                                 every=1, count=3, param=5.0))
    replica_srv = _serve(svc, fault=plan.for_component("replica", 0, 0))
    sh = Shard(f"http://127.0.0.1:{writer_srv.port}",
               [f"http://127.0.0.1:{replica_srv.port}"], timeout=0.4)
    router = RouterService([sh], timeout=3.0, probe_interval=0.05,
                           probe_timeout=0.4)
    try:
        replica = sh.replicas[0]
        out = router.query(k=3)
        assert not out["degraded"]
        _wait_for(lambda: replica.breaker.is_open, timeout=15,
                  what="replica circuit open")
        assert sh.reader() is sh.writer
        _wait_for(lambda: not replica.breaker.is_open, timeout=30,
                  what="replica circuit re-closed")
        stats = router.resilience_stats()
        assert stats["probes"] >= 1
        assert any(b["trips"] >= 1 for b in stats["breakers"])
        out = router.query(k=3)
        assert not out["degraded"] and out["coverage"] == [0]
    finally:
        router.close()
        for sv in (writer_srv, replica_srv):
            sv.shutdown()
            sv.server_close()
        svc.stop()


def test_stale_keepalive_retries_once_on_fresh_connection():
    svc = _service(6)
    server = _serve(svc)
    port = server.port
    sh = Shard(f"http://127.0.0.1:{port}", timeout=5.0)
    try:
        assert sh.writer.call("/health")["version"] >= 1
        server.shutdown()
        server.server_close()                # keep-alive now stale
        server = make_server(svc, port=port)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        assert sh.writer.call("/health")["version"] >= 1
        assert not sh.writer.breaker.is_open
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
