"""The port's multi-process serving plane on the CPU:
``python -m repro_torch.launch.cluster_serve --device cpu`` with shard
writers, shared-memory replicas, the router and the supervisor, each in
its own spawned process.

* The plane over ``--dataset random --n-tuples 2000 --shards 2
  --replicas 1`` answers the router's top-k and a batch exactly as an
  in-process router over two in-process writers of the same shard rows
  (``serve.router`` over threads, as ``tests/test_torch_serve_router.py``
  builds it); the smoke client then passes (cross-shard read-your-writes
  included), the launcher exits 0 and leaves no shared-memory segment.
* A writer killed at its first write after the preload is restarted by
  the supervisor and recovers the write from its checkpoint and WAL.
* The twin of ``tests/test_obs.py``'s live trace test: one trace id
  stitched across the router and two replica processes, with an
  injected retry and a degraded shard; the writers expose their kernel
  launch counts on ``/metrics``.
"""
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

from repro_torch.core import keys as K
from repro_torch.core import runs as RS
from repro_torch.launch.tricluster import load_dataset
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.protocol import ClusterClient, make_server
from repro_torch.serve.router import RouterService, Shard
from repro_torch.serve.service import TriclusterService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TUPLES = 2000


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{what} not reached in {timeout}s")
        time.sleep(0.02)


def _get_text(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode()


def _get_json(url, timeout=10.0):
    return json.loads(_get_text(url, timeout))


def _post_json(url, doc, timeout=10.0):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


class _Plane:
    """A launched plane: its process, its stdout lines, its router."""

    def __init__(self, tmp_path, *flags):
        self.port_file = tmp_path / f"router{len(flags)}.port"
        cmd = [sys.executable, "-m", "repro_torch.launch.cluster_serve",
               "--device", "cpu", "--dataset", "random", "--n-tuples",
               str(N_TUPLES), "--shards", "2", "--replicas", "1",
               "--port", "0", "--port-file", str(self.port_file), *flags]
        self.proc = subprocess.Popen(cmd, env=_env(), text=True, cwd=ROOT,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
        self.lines = []
        threading.Thread(target=lambda: self.lines.extend(self.proc.stdout),
                         daemon=True).start()
        _wait_for(lambda: self.port_file.exists()
                  and self.port_file.read_text().strip(), timeout=120,
                  what="router port file")
        self.base = f"http://127.0.0.1:{int(self.port_file.read_text())}"
        self.client = ClusterClient(self.base, timeout=60)

    def ports(self):
        """Backend ports as the children announce them on stdout (one
        pipe: two announcements may share a line)."""
        out = {}
        for ln in list(self.lines):
            for m in re.finditer(r"\[(replica-\d+\.\d+|shard-\d+)\]"
                                 r"[^\[]*port=(\d+)", ln):
                out[m.group(1)] = int(m.group(2))
        return out

    def close(self):
        if self.proc.poll() is None:
            try:
                _post_json(f"{self.base}/shutdown", {}, timeout=10)
            except OSError:
                pass
        try:
            return self.proc.wait(timeout=90)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()


def _in_process_router():
    """Two in-process writers over the plane's shard rows (the same
    dataset, partition and preload chunks), behind an in-process router."""
    ctx = load_dataset("random", N_TUPLES, 0)
    own = RS.shard_of_rows(ctx.tuples, K.plan_mode_key(
        ctx.sizes, 0, with_values=False), 2)
    svcs, servers = [], []
    for s in range(2):
        rows = ctx.tuples[own == s]
        svc = TriclusterService(ctx.sizes, seed=0x5EED, device="cpu",
                                refresh_interval=3600.0,
                                dirty_threshold=10**9)
        step = -(-rows.shape[0] // 4)
        for lo in range(0, rows.shape[0], step):
            svc.add(rows[lo:lo + step])
        svcs.append(svc.start())
        server = make_server(svc, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
    router = RouterService([Shard(f"http://127.0.0.1:{sv.port}")
                            for sv in servers], timeout=30.0)
    return router, svcs, servers


def _answers(query, query_batch):
    keep = ("version", "shard_versions", "hits", "degraded", "coverage")
    return [{k: d[k] for k in keep} for d in (
        query(k=10, include_components=True),
        query(entity=3, mode=1, k=10),
        query_batch(list(range(64)), mode=0, k=5))]


def test_plane_answers_as_the_in_process_router_then_smoke(tmp_path):
    plane = _Plane(tmp_path)
    try:
        plane.client.wait_ready(timeout=120)
        got = _answers(plane.client.query, plane.client.query_batch)
        router, svcs, servers = _in_process_router()
        try:
            want = _answers(router.query, router.query_batch)
        finally:
            router.close()
            for sv in servers:
                sv.shutdown()
                sv.server_close()
            for svc in svcs:
                svc.stop()
        assert want[0]["hits"] and got == want
        smoke = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.cluster_serve",
             "--smoke-client", "--port-file", str(plane.port_file)],
            env=_env(), cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        assert smoke.returncode == 0, smoke.stdout + smoke.stderr
        assert "[serve-smoke] PASS" in smoke.stdout
        assert "cross-shard read-your-writes OK" in smoke.stdout
        assert plane.proc.wait(timeout=90) == 0
    finally:
        plane.close()
    text = "".join(plane.lines)
    assert "device=cpu" in text and "[cluster-serve] stopped" in text
    prefix = f"cs{plane.proc.pid}s"
    if os.path.isdir("/dev/shm"):
        assert not [e for e in os.listdir("/dev/shm")
                    if e.startswith(prefix)]


def test_killed_writer_restarts_and_recovers(tmp_path):
    """``kill_writer(0, at_stream_version=5)``: shard 0's first write
    after its 4 preload chunks lands in the WAL, then the writer dies;
    the supervisor restarts it, the restarted writer recovers the write,
    and an ``at_least_version`` read returns the written row's
    cluster."""
    plan = FaultPlan.build(FaultPlan.kill_writer(0, at_stream_version=5))
    plane = _Plane(tmp_path, "--fault-plan", plan.to_json(), "--metrics",
                   "--router-timeout", "120")
    try:
        cl = plane.client
        cl.wait_ready(timeout=120)
        ctx = load_dataset("random", N_TUPLES, 0)
        own = RS.shard_of_rows(ctx.tuples, K.plan_mode_key(
            ctx.sizes, 0, with_values=False), 2)
        row = ctx.tuples[own == 0][0].copy()
        row[2] = (row[2] + 1) % ctx.sizes[2]
        up = cl.upsert([row.tolist()])
        assert up["shards"] == [0]
        tok = cl.refresh()["shard_versions"]
        out = cl.query(entity=int(row[0]), mode=0, k=10**4,
                       include_components=True, at_least_version=tok,
                       timeout=60)
        assert any(all(int(row[j]) in h["components"][j] for j in range(3))
                   for h in out["hits"])
        text = _get_text(f"{plane.base}/metrics")
        assert 'repro_supervisor_child_restarts{child="shard-0"} 1' in text
        assert 'repro_supervisor_child_restarts{child="shard-1"} 0' in text
        assert plane.close() == 0
    finally:
        plane.close()
    assert any("[shard-0] recovered" in ln for ln in plane.lines)


def test_trace_stitches_across_processes(tmp_path):
    """Twin of ``tests/test_obs.py``'s live trace test: replica-0.0 drops
    its next two requests (the router retries and succeeds) and
    replica-1.0 is delayed past the router's budget (shard 1 degrades);
    one trace id stitches the router and both replica processes."""
    plan = FaultPlan.build(
        FaultPlan.drop_requests("replica", 0, at=2, every=1, count=2),
        FaultPlan.slow_requests("replica", 1, at=2, delay_s=5.0), seed=11)
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(plan.to_json())
    plane = _Plane(tmp_path, "--metrics", "--slow-query-ms", "0",
                   "--no-supervise", "--router-timeout", "2",
                   "--fault-plan", str(plan_file))
    base = plane.base
    try:
        _wait_for(lambda: {"replica-0.0", "replica-1.0", "shard-0"}
                  <= set(plane.ports()), timeout=60,
                  what="backend port announcements")
        ports = plane.ports()
        out = _post_json(f"{base}/query", {"k": 5}, timeout=30)
        assert out["degraded"] is True and out["coverage"] == [0]
        tid = out["trace_id"]
        assert re.fullmatch(r"[0-9a-f]{16}", tid)
        _wait_for(lambda: any(e.get("trace_id") == tid for e in
                              _get_json(f"{base}/debug/slow")["slowest"]),
                  timeout=30, what="router slow-log entry")
        rspans = _get_json(f"{base}/debug/trace?trace_id={tid}")["spans"]
        by_name = {}
        for s in rspans:
            by_name.setdefault(s["name"], []).append(s)
        (root,) = by_name["router/query"]
        assert root["parent_id"] is None
        shard_sp = {s["attrs"]["shard"]: s for s in by_name["router.shard"]}
        assert set(shard_sp) == {0, 1}
        assert all(s["parent_id"] == root["span_id"]
                   for s in shard_sp.values())
        attempts = by_name["router.attempt"]
        assert all(a["parent_id"] == shard_sp[a["attrs"]["shard"]]
                   ["span_id"] for a in attempts)
        s0 = [a["attrs"]["outcome"] for a in attempts
              if a["attrs"]["shard"] == 0]
        assert "retry" in s0 and s0[-1] == "ok"
        assert "ok" not in [a["attrs"]["outcome"] for a in attempts
                            if a["attrs"]["shard"] == 1]
        (drop,) = by_name["router.degraded_drop"]
        assert drop["attrs"]["shard"] == 1 and drop["status"] == "error"
        assert drop["parent_id"] == root["span_id"]
        attempt_ids = {a["span_id"] for a in attempts}

        def replica_spans(name):
            try:
                return [s for s in _get_json(
                    f"http://127.0.0.1:{ports[name]}/debug/trace"
                    f"?trace_id={tid}")["spans"]
                    if s["name"] == "serve/query"]
            except OSError:
                return []

        _wait_for(lambda: replica_spans("replica-0.0"), timeout=30,
                  what="replica-0.0 serve/query span")
        _wait_for(lambda: replica_spans("replica-1.0"), timeout=30,
                  what="replica-1.0 serve/query span")
        r0, r1 = replica_spans("replica-0.0"), replica_spans("replica-1.0")
        assert all(s["parent_id"] in attempt_ids for s in r0 + r1)
        assert len({s["pid"] for s in rspans + r0 + r1}) >= 3
        (ent,) = [e for e in _get_json(f"{base}/debug/slow")["slowest"]
                  if e.get("trace_id") == tid]
        assert ent["endpoint"] == "/query" and ent["coverage"] == [0]
        assert ent["handler_ms"] is not None and ent["wait_ms"] is not None
        text = _get_text(f"{base}/metrics")
        assert ('repro_router_endpoint_latency_ms_count'
                '{endpoint="/query"} 1.0') in text
        assert 'repro_router_request_ms_count{endpoint="/query"} 1' in text
        assert "repro_router_breaker_open" in text
        # the writers count their kernel launches (none on the CPU)
        wtext = _get_text(f"http://127.0.0.1:{ports['shard-0']}/metrics")
        for name in ("segment_reduce", "radix_histogram", "radix_rank"):
            assert f'repro_kernel_launches{{kernel="{name}"}} 0.0' in wtext
    finally:
        plane.close()
