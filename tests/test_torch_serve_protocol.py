"""The port's HTTP endpoint and client (``repro_torch.serve.protocol``).

Parity: the port's ``make_server`` over the port's service and the JAX
package's ``make_server`` over the JAX package's service, fed the same
rows, answer ``/query`` (scalar, batch, top-k with components,
signature), ``/stats`` and ``/health`` with equal JSON, apart from the
fields named in :data:`VOLATILE` (times, wall clocks, trace ids).
Twins, against the port: ``tests/test_serve_protocol.py``,
``tests/test_serve_faults.py``'s ``TestHealth503AndDrain`` and
``TestBackpressure``, and ``tests/test_obs.py``'s two HTTP tests of the
in-process server."""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.serve.protocol import make_server as jmake_server
from repro.serve.service import TriclusterService as JService
from repro_torch.data import synthetic
from repro_torch.obs import TRACE_HEADER, Obs
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.protocol import ClusterClient, health_doc, make_server
from repro_torch.serve.service import QueryResult, TriclusterService

SIZES = (24, 12, 8)
QUIET = dict(refresh_interval=3600.0, dirty_threshold=10**9,
             scrub_interval=0.0)
#: fields whose values are times, wall clocks or trace ids: excluded from
#: the comparison of the two packages' documents (their keys still are)
VOLATILE = ("server_ms", "trace_id", "staleness_s", "last_mine_ms",
            "total_mine_ms", "last_index_build_ms")


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


def _stable(doc):
    """``doc`` with the volatile fields' values blanked, recursively."""
    if isinstance(doc, dict):
        return {k: (None if k in VOLATILE else _stable(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_stable(v) for v in doc]
    return doc


@pytest.fixture(scope="module")
def pair():
    """The same rows behind each package's server."""
    rows = np.random.default_rng(41).integers(0, SIZES, size=(240, 3))
    svcs = [JService(SIZES, seed=9, **QUIET),
            TriclusterService(SIZES, seed=9, device="cpu", **QUIET)]
    servers = []
    for svc, maker in zip(svcs, (jmake_server, make_server)):
        svc.add(rows)
        svc.start()
        servers.append(_serve(svc, maker))
    clients = [ClusterClient(f"http://127.0.0.1:{s.port}") for s in servers]
    yield rows, svcs, clients
    for s in servers:
        s.shutdown()
        s.server_close()
    for svc in svcs:
        svc.stop()


def _both(clients, call):
    docs = [_stable(call(cl)) for cl in clients]
    assert docs[1] == docs[0]
    return docs[1]


def test_documents_equal_jax(pair):
    rows, svcs, clients = pair
    top = _both(clients, lambda cl: cl.query(k=7, include_components=True))
    assert top["hits"] and top["hits"][0]["components"]
    sig = top["hits"][2]["signature"]
    assert _both(clients, lambda cl: cl.query(
        signature=sig, include_components=True))["hits"][0]["signature"] \
        == sig
    _both(clients, lambda cl: cl.query(signature=[1, 2]))
    for mode in (None, 0, 2):
        e = int(rows[5, mode or 0])
        _both(clients, lambda cl: cl.query(entity=e, mode=mode, k=4,
                                           include_components=True))
    batch = _both(clients, lambda cl: cl.query_batch(
        list(range(SIZES[1])), mode=1, k=3, include_components=True))
    assert len(batch["hits"]) == SIZES[1]
    assert _both(clients, lambda cl: cl.health())["healthy"]
    assert _both(clients, lambda cl: cl.stats())["sizes"] == list(SIZES)


def test_writes_equal_jax(pair):
    rows, svcs, clients = pair
    fresh = np.random.default_rng(42).integers(0, SIZES, size=(12, 3))
    _both(clients, lambda cl: cl.upsert(fresh.tolist()))
    _both(clients, lambda cl: cl.delete(rows[:4].tolist()))
    ref = _both(clients, lambda cl: cl.refresh())
    _both(clients, lambda cl: cl.query(
        entity=int(fresh[0, 0]), mode=0, at_least_version=ref["version"],
        timeout=30, include_components=True))
    _both(clients, lambda cl: cl.query_batch(
        fresh[:, 2].tolist(), mode=2, k=5))
    _both(clients, lambda cl: cl.health())
    _both(clients, lambda cl: cl.stats())


# -- twins of tests/test_serve_protocol.py ----------------------------------

@pytest.fixture(scope="module")
def served():
    ctx = synthetic.random_context((8, 7, 6), 96, seed=7)
    svc = TriclusterService(ctx.sizes, refresh_interval=0.01,
                            dirty_threshold=1, device="cpu")
    svc.add(ctx.tuples)
    svc.start()
    server = _serve(svc)
    yield ctx, svc, ClusterClient(f"http://127.0.0.1:{server.port}")
    server.shutdown()
    server.server_close()
    svc.stop()


def test_health_and_stats(served):
    ctx, svc, cl = served
    h = cl.health()
    assert h["version"] >= 1 and h["clusters"] == len(svc.snapshot().index)
    st = cl.stats()
    assert st["sizes"] == list(ctx.sizes) and st["publishes"] >= 1


def test_scalar_query_matches_service(served):
    ctx, svc, cl = served
    e = int(ctx.tuples[0, 1])
    got = cl.query(entity=e, mode=1, k=5, include_components=True)
    want = svc.query(entity=e, mode=1, k=5)
    if got["version"] == want.version:
        assert [tuple(h["signature"]) for h in got["hits"]] \
            == [v.signature for v, _ in want.hits]
        assert [sorted(c) for c in want.hits[0][0].components] \
            == got["hits"][0]["components"]


def test_batch_and_signature_query(served):
    ctx, svc, cl = served
    ents = list(range(8))
    got = cl.query_batch(ents, mode=0, k=3)
    assert len(got["hits"]) == len(ents)
    scalar = cl.query(entity=ents[0], mode=0, k=3)
    if scalar["version"] == got["version"]:
        assert got["hits"][0] == scalar["hits"]
    sig = cl.query(k=1)["hits"][0]["signature"]
    assert [h["signature"] for h in cl.query(signature=sig)["hits"]] \
        == [sig]
    assert cl.query(signature=[0, 0])["hits"] == []


def test_write_refresh_freshness(served):
    ctx, svc, cl = served
    v0 = cl.health()["version"]
    up = cl.upsert(ctx.tuples[:2].tolist())
    assert up["stream_version"] == svc.stream_version
    ref = cl.refresh()
    assert ref["version"] > v0
    fresh = cl.query(entity=0, at_least_version=ref["version"], timeout=30)
    assert fresh["version"] >= ref["version"]
    d = cl.delete(ctx.tuples[:1].tolist())
    assert d["stream_version"] > up["stream_version"]


def test_errors(served):
    _, _, cl = served
    with pytest.raises(RuntimeError, match="out of range"):
        cl.query(entity=0, mode=9)
    with pytest.raises(RuntimeError, match="rows"):
        cl.upsert([])
    with pytest.raises(RuntimeError, match="not published"):
        cl.query(entity=0, at_least_version=10_000, timeout=0.05)


# -- twins of TestHealth503AndDrain -----------------------------------------

class _StubService:
    """Service-shaped object with scriptable health inputs."""
    read_only = True
    version = 3
    stream_version = 5
    dirty = 2
    dirty_clusters = 0
    _snap = None

    def __init__(self):
        self.thread_alive = True
        self.stale = 0.1
        self.block = None

    def staleness_s(self):
        return self.stale

    def stats(self):
        return {"role": "stub"}

    def query(self, **kw):
        if self.block is not None:
            self.block.wait(10)
        return QueryResult(self.version, self.stream_version, [])


def test_health_503_on_dead_thread_and_staleness():
    svc = _StubService()
    server = _serve(svc, health_max_staleness=5.0)
    try:
        cl = ClusterClient(f"http://127.0.0.1:{server.port}", timeout=10)
        h = cl.health()
        assert h["healthy"] and "http_status" not in h
        svc.stale = 60.0
        h = cl.health()
        assert h["http_status"] == 503 and not h["healthy"]
        assert "stale" in h["error"]
        svc.stale = 0.1
        svc.thread_alive = False
        h = cl.health()
        assert h["http_status"] == 503 and "thread" in h["error"]
    finally:
        server.shutdown()
        server.server_close()


def test_health_doc_thresholds():
    svc = _StubService()
    assert health_doc(svc)["healthy"]
    svc.stale = 99.0
    assert health_doc(svc)["healthy"]          # no threshold set
    assert not health_doc(svc, max_staleness_s=1.0)["healthy"]
    svc.dirty = 0                              # drained: stale is fine
    assert health_doc(svc, max_staleness_s=1.0)["healthy"]


def test_drain_waits_for_inflight():
    svc = _StubService()
    svc.block = threading.Event()
    server = _serve(svc)
    cl = ClusterClient(f"http://127.0.0.1:{server.port}", timeout=30)
    res = {}
    t = threading.Thread(target=lambda: res.update(cl.query(entity=0)),
                         daemon=True)
    t.start()
    _wait_for(lambda: server.inflight == 1, what="in-flight request")
    server.shutdown()                    # stop accepting
    assert not server.drain_inflight(timeout=0.2)
    svc.block.set()
    assert server.drain_inflight(timeout=10)
    t.join(timeout=10)
    assert res["version"] == 3
    server.server_close()


def test_injected_drop_severs_connection():
    inj = FaultPlan.build(FaultPlan.drop_requests("replica", -1, at=2)
                          ).for_component("replica", 0)
    server = _serve(_StubService(), fault=inj)
    try:
        cl = ClusterClient(f"http://127.0.0.1:{server.port}", timeout=5)
        assert cl.health()["version"] == 3
        with pytest.raises(OSError):
            cl.health()                      # request 2 severed
        assert cl.health()["version"] == 3
    finally:
        server.shutdown()
        server.server_close()


# -- twin of TestBackpressure -----------------------------------------------

def test_429_retry_after_and_drain():
    rng = np.random.default_rng(21)
    svc = TriclusterService(SIZES, refresh_interval=0.05, seed=21,
                            device="cpu")
    svc.add(rng.integers(0, SIZES, size=(40, 3)).astype(np.int64))
    svc.refresh()
    server = _serve(svc, max_write_backlog=2)
    try:
        cl = ClusterClient(f"http://127.0.0.1:{server.port}", timeout=30)
        assert cl.upsert([[0, 0, 0]])["stream_version"] == 2
        assert cl.upsert([[1, 1, 1]])["stream_version"] == 3
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="backlog"):
            cl.upsert([[2, 2, 2]])
        assert time.monotonic() - t0 >= 0.1      # 2x refresh_interval
        assert server.throttled_writes == 2 and svc.stream_version == 3
        svc.refresh()
        assert cl.upsert([[2, 2, 2]])["stream_version"] == 4
        assert cl.upsert([[3, 3, 3]])["stream_version"] == 5

        def _drain():
            _wait_for(lambda: server.throttled_writes >= 3,
                      what="third throttle")
            svc.refresh()
        t = threading.Thread(target=_drain, daemon=True)
        t.start()
        assert cl.upsert([[4, 4, 4]])["stream_version"] == 6
        t.join(timeout=30)
        assert server.throttled_writes == 3
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()


# -- twins of tests/test_obs.py's in-process server tests -------------------

def _get_text(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _service(**kw):
    rng = np.random.default_rng(3)
    svc = TriclusterService(SIZES, refresh_interval=0.05, dirty_threshold=4,
                            seed=3, device="cpu", **kw)
    svc.add(rng.integers(0, SIZES, size=(160, 3)).astype(np.int64))
    return svc.start()


def test_obs_endpoints_404_without_metrics():
    svc = _service()
    server = _serve(svc)
    try:
        for p in ("/metrics", "/debug/trace", "/debug/slow"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get_text(f"http://127.0.0.1:{server.port}{p}")
            assert ei.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()


def test_backend_adopts_trace_header():
    obs = Obs.create(service="unit", slow_query_ms=0.0)
    svc = _service(obs=obs)
    server = _serve(svc, obs=obs)
    base = f"http://127.0.0.1:{server.port}"
    try:
        req = urllib.request.Request(
            f"{base}/query", data=json.dumps({"k": 3}).encode(),
            headers={"Content-Type": "application/json",
                     TRACE_HEADER: "aabbccdd/11223344"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert "hits" in json.loads(r.read())
        url = f"{base}/debug/trace?trace_id=aabbccdd"
        _wait_for(lambda: json.loads(_get_text(url))["spans"],
                  timeout=10.0, what="serve/query span in ring")
        (sp,) = [s for s in json.loads(_get_text(url))["spans"]
                 if s["name"] == "serve/query"]
        assert sp["parent_id"] == "11223344"
        assert sp["service"] == "unit" and sp["status"] == "ok"
        text = _get_text(f"{base}/metrics")
        assert 'repro_server_request_ms_count{endpoint="/query"' in text
        assert "repro_server_requests_total" in text
        slow = json.loads(_get_text(f"{base}/debug/slow"))
        assert any(e["trace_id"] == "aabbccdd" for e in slow["slowest"])
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
