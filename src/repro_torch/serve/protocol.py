"""Thin stdlib HTTP/JSON endpoint + client for the cluster service.
Port of ``repro.serve.protocol``: the same routes, status codes and JSON
over the port's ``TriclusterService`` (a writer mining on its device)
or ``serve.shm.ReplicaService`` (host arrays only).

The service itself (``serve.service``) is in-process; this module makes
it drivable from outside: a ``ThreadingHTTPServer`` front-end (one OS
thread per connection — every request is a lock-free snapshot read, so
plain threads are plenty) and a ``urllib``-based :class:`ClusterClient`.
No third-party dependencies; wire format is JSON.

Routes (all bodies/responses JSON):

* ``GET /health`` — ``{version, stream_version, clusters, dirty,
  dirty_clusters, staleness_s, role}``: ``dirty`` is the write backlog
  (writes not yet covered by the published snapshot),
  ``dirty_clusters`` how many cluster signatures changed at the last
  swap, ``staleness_s`` the seconds since the served snapshot was
  published (wall-clock on replicas — comparable across processes)
* ``GET /stats`` — full service stats (includes ``sizes`` so clients
  can build valid rows/entities without out-of-band knowledge)
* ``POST /query`` — ``{entity | entities | signature, mode?, k?,
  at_least_version?, timeout?, include_components?}``; with
  ``entities`` the batched path answers the whole list in one
  stacked-window pass and ``hits`` is one list per entity.  Responses
  carry ``server_ms`` — handler wall time, so clients can attribute
  tail latency to queue wait vs handler work
* ``POST /upsert`` / ``POST /delete`` — ``{rows, values?}``; returns
  ``{stream_version, dirty}`` (the background thread picks the write up
  on its cadence/threshold; follow with ``/refresh`` to force).
  **501** on a read-only replica (``serve.shm.ReplicaService``) —
  writes go to the shard's writer endpoint.  **429** + ``Retry-After``
  when the server was built with ``max_write_backlog`` and the
  pending-write backlog (writes since the last published snapshot) has
  reached it — write backpressure: the miner is behind, keep accepting
  and it degrades unboundedly.  :class:`ClusterClient` honours
  ``Retry-After`` once before surfacing the error
* ``POST /refresh`` — synchronous re-mine + swap; returns the new
  ``{version, stream_version, clusters}`` (**501** on a replica)
* ``POST /shutdown`` — stop serving (enabled by default; pass
  ``allow_shutdown=False`` to :func:`make_server` to disable)

Signatures travel as ``[lo, hi]`` pairs — the cross-engine cluster
identity, so a signature minted by a batch job yesterday resolves over
HTTP against today's streaming snapshot.

**Load-balancer contract.**  A fleet of replicas behind one writer (or
a ``serve.router`` fan-out over several shards) is balanced on two
/health signals, both cheap lock-free reads:

* *readiness* — route queries to a backend once ``version >= 1``;
  ``ClusterClient.wait_ready`` polls exactly this.
* *freshness* — ``staleness_s`` + ``dirty``: a backend whose
  ``staleness_s`` grows while ``dirty > 0`` has a stuck writer (or a
  replica whose publisher died) and should be drained;
  ``ClusterClient.wait_until_fresh`` blocks on the complementary
  condition (backlog drained and snapshot younger than a bound).
  Replicas of the same shard report the same ``version`` stream, so a
  balancer may also pin ``at_least_version`` tokens (read-your-writes)
  to any replica of the shard that served the write.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib import error as _uerror
from urllib import request as _urequest
from urllib.parse import parse_qs

from ..obs import NULL_OBS, TRACE_HEADER, parse_trace_header
from .faults import DropRequest
from .service import QueryResult, TriclusterService


def health_doc(svc, max_staleness_s: Optional[float] = None) -> dict:
    """The /health body for any service-shaped object (in-process
    writer or shared-memory replica).  ``healthy`` goes False — and the
    HTTP route answers **503** — when the background thread (miner on a
    writer, attach loop on a replica) has died, when the integrity
    scrubber found corruption in the served snapshot (``scrub_clean``
    False — serving known-bad structures would be silently wrong
    answers), or when ``max_staleness_s`` is set and the served
    snapshot is older than that with writes outstanding: all mean a
    balancer must eject the backend, and a 200 would keep it in
    rotation."""
    snap = getattr(svc, "_snap", None)
    stale = svc.staleness_s() if hasattr(svc, "staleness_s") else None
    if stale is not None and stale == float("inf"):
        stale = None
    alive = bool(getattr(svc, "thread_alive", True))
    scrub_ok = bool(getattr(svc, "scrub_clean", True))
    doc = {"version": svc.version,
           "stream_version": svc.stream_version,
           "clusters": 0 if snap is None else len(snap.index),
           "dirty": svc.dirty,
           "dirty_clusters": int(getattr(svc, "dirty_clusters", 0)),
           "staleness_s": stale,
           "thread_alive": alive,
           "scrub_clean": scrub_ok,
           "role": ("replica" if getattr(svc, "read_only", False)
                    else "writer")}
    healthy, why = True, None
    if not alive:
        healthy, why = False, "background thread died"
    elif not scrub_ok:
        # the integrity scrubber found corruption in the served
        # structures: wrong answers are worse than no answers — eject
        healthy, why = False, "integrity scrub failed: corruption " \
            "detected in served snapshot"
    elif (max_staleness_s is not None and stale is not None
            and stale > max_staleness_s and doc["dirty"] > 0):
        healthy, why = False, (f"stale snapshot: {stale:.1f}s > "
                               f"{max_staleness_s:.1f}s with "
                               f"dirty={doc['dirty']}")
    doc["healthy"] = healthy
    if why is not None:
        doc["error"] = why
    return doc


def hit_doc(view, score: float, include_components: bool = False) -> dict:
    """JSON form of one ranked hit."""
    d = {"signature": [int(view.signature[0]), int(view.signature[1])],
         "score": float(score), "density": float(view.density),
         "volume": float(view.volume), "gen_count": int(view.gen_count)}
    if include_components:
        d["components"] = [sorted(int(e) for e in c)
                           for c in view.components]
    return d


def _query_doc(res: QueryResult, batched: bool,
               include_components: bool) -> dict:
    if batched:
        hits = [[hit_doc(v, s, include_components) for v, s in per]
                for per in res.hits]
    else:
        hits = [hit_doc(v, s, include_components) for v, s in res.hits]
    return {"version": res.version, "stream_version": res.stream_version,
            "hits": hits}


#: GET routes served by the observability plane (DESIGN.md §11) — the
#: same three on the service endpoint and the router
OBS_PATHS = ("/metrics", "/debug/trace", "/debug/slow")


def handle_obs_get(handler, obs) -> bool:
    """Serve the observability GET routes on any JSON handler that has
    a ``_reply(doc, status)`` method.  Returns True when ``handler.path``
    was one of :data:`OBS_PATHS` (whether it answered data or the
    disabled-404); False means "not mine, keep dispatching".

    * ``/metrics`` — Prometheus text exposition of the process registry
      (native instruments + collector-folded stats dicts).
    * ``/debug/trace[?trace_id=..&limit=N]`` — the span ring as JSON.
    * ``/debug/slow`` — the slow-query ring, slowest first.
    """
    path, _, qs = handler.path.partition("?")
    if path not in OBS_PATHS:
        return False
    if obs is None or not obs.enabled:
        handler._reply({"error": "observability disabled — launch "
                        "with --metrics"}, 404)
        return True
    if path == "/metrics":
        body = obs.metrics.expose().encode()
        handler.send_response(200)
        handler.send_header("Content-Type",
                            "text/plain; version=0.0.4; charset=utf-8")
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)
    elif path == "/debug/trace":
        params = parse_qs(qs)
        tid = (params.get("trace_id") or [None])[0]
        try:
            limit = int((params.get("limit") or [0])[0])
        except ValueError:
            limit = 0
        handler._reply({"service": obs.service,
                        "dropped": obs.tracer.dropped,
                        "spans": obs.tracer.spans(tid, limit)})
    else:
        handler._reply({"service": obs.service,
                        "stats": obs.slow.stats(),
                        "slowest": obs.slow.entries()})
    return True


class _Handler(BaseHTTPRequestHandler):
    # quiet by default: the load generator would otherwise spam stderr
    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _reply(self, doc: dict, status: int = 200,
               headers: Optional[dict] = None) -> None:
        self._status = status            # for the request instruments
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _service(self) -> TriclusterService:
        return self.server.service

    def _enter(self) -> bool:
        """Per-request entry: fire the ``request`` fault site (the
        chaos plane's drop/slow/hang injection point) and register the
        request for drain accounting.  Returns False when the request
        must be severed with no response bytes (an injected torn
        backend) — the caller just returns."""
        inj = getattr(self.server, "fault", None)
        if inj is not None:
            try:
                inj.fire("request")
            except DropRequest:
                self.close_connection = True
                return False
        return True

    def do_GET(self):
        if not self._enter():
            return
        with self.server.track_request():
            svc = self._service()
            if self.path == "/health":
                doc = health_doc(
                    svc, getattr(self.server, "health_max_staleness", None))
                self._reply(doc, 200 if doc["healthy"] else 503)
            elif self.path == "/stats":
                self._reply(svc.stats())
            elif handle_obs_get(self, self.server.obs):
                pass
            else:
                self._reply({"error": f"unknown path {self.path}"}, 404)

    def do_POST(self):
        t_recv = time.perf_counter()
        if not self._enter():
            return
        with self.server.track_request():
            obs = self.server.obs
            if not obs.enabled:
                return self._post()
            # adopt the caller's trace (router fan-out) or mint a fresh
            # one — this span is the backend's "handled it" record
            tid, pid = parse_trace_header(self.headers.get(TRACE_HEADER))
            role = ("replica" if getattr(self._service(), "read_only",
                                         False) else "writer")
            sp = obs.tracer.start(f"serve{self.path}", trace_id=tid,
                                  parent_id=pid, role=role)
            self._cur_span = sp
            self._status = 200
            t0 = time.perf_counter()
            try:
                self._post()
            finally:
                now = time.perf_counter()
                handler_ms = (now - t0) * 1e3
                total_ms = (now - t_recv) * 1e3
                status = self._status
                sp.set("status", status)
                if status >= 500:
                    sp.error(f"HTTP {status}")
                sp.finish()
                ep = (self.path if self.path in
                      ("/query", "/upsert", "/delete", "/refresh",
                       "/shutdown") else "other")
                pair = self.server._req_instruments.get((ep, status))
                if pair is None:
                    pair = (obs.metrics.histogram("server_request_ms",
                                                  endpoint=ep, role=role),
                            obs.metrics.counter("server_requests_total",
                                                endpoint=ep,
                                                code=str(status),
                                                role=role))
                    self.server._req_instruments[(ep, status)] = pair
                pair[0].observe(handler_ms)
                pair[1].inc()
                if ep == "/query":
                    # wait = receive-to-handler (fault delays, body
                    # read); handler = the dispatch itself
                    obs.slow.record(ep, total_ms, handler_ms=handler_ms,
                                    wait_ms=total_ms - handler_ms,
                                    trace_id=sp.trace_id)

    def _post(self):
        svc = self._service()
        try:
            n = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            return self._reply({"error": f"bad JSON body: {e}"}, 400)
        try:
            if self.path == "/query":
                self._reply(self._query(svc, doc))
            elif self.path in ("/upsert", "/delete", "/refresh") and \
                    getattr(svc, "read_only", False):
                self._reply({"error": f"{self.path} on a read-only "
                             "replica — send writes to the shard's "
                             "writer endpoint"}, 501)
            elif self.path in ("/upsert", "/delete"):
                self._mutate(svc, doc, self.path[1:])
            elif self.path == "/refresh":
                snap = svc.refresh()
                self._reply({"version": snap.version,
                             "stream_version": snap.stream_version,
                             "clusters": len(snap.index)})
            elif self.path == "/shutdown":
                if not getattr(self.server, "allow_shutdown", True):
                    return self._reply({"error": "shutdown disabled"}, 403)
                self._reply({"ok": True})
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
            else:
                self._reply({"error": f"unknown path {self.path}"}, 404)
        except TimeoutError as e:
            self._reply({"error": str(e)}, 504)
        except (ValueError, KeyError, IndexError, OverflowError,
                TypeError, RuntimeError) as e:
            # malformed-but-parseable input must get the JSON error
            # contract, not a torn connection
            self._reply({"error": str(e)}, 400)

    def _query(self, svc: TriclusterService, doc: dict) -> dict:
        t0 = time.perf_counter()
        alv = doc.get("at_least_version")
        common = dict(k=int(doc.get("k", 10)),
                      at_least_version=(None if alv is None else int(alv)),
                      timeout=doc.get("timeout"))
        mode = doc.get("mode")
        mode = None if mode is None else int(mode)
        inc = bool(doc.get("include_components", False))
        if "entities" in doc:
            res = svc.query_batch([int(e) for e in doc["entities"]],
                                  mode=mode, **common)
            out = _query_doc(res, True, inc)
        else:
            sig = doc.get("signature")
            res = svc.query(
                entity=(None if doc.get("entity") is None
                        else int(doc["entity"])),
                mode=mode,
                signature=(None if sig is None
                           else (int(sig[0]), int(sig[1]))),
                **common)
            out = _query_doc(res, False, inc)
        # handler wall time: the client subtracts this from its own
        # round-trip to attribute tail latency (queue vs handler)
        out["server_ms"] = (time.perf_counter() - t0) * 1e3
        sp = getattr(self, "_cur_span", None)
        if sp is not None and sp.trace_id:
            out["trace_id"] = sp.trace_id
        return out

    def _mutate(self, svc: TriclusterService, doc: dict,
                op: str) -> None:
        rows = doc.get("rows")
        if not rows:
            raise ValueError(f"/{op} needs non-empty 'rows'")
        limit = int(getattr(self.server, "max_write_backlog", 0) or 0)
        if limit and svc.dirty >= limit:
            # write backpressure: the miner is `limit` writes behind
            # the published snapshot — admitting more just grows the
            # backlog unboundedly.  429 + Retry-After sized to the
            # re-mine cadence tells well-behaved clients when the
            # backlog plausibly drained
            retry_s = max(2 * float(getattr(svc, "refresh_interval",
                                            0.25)), 0.05)
            self.server.throttled_writes += 1
            return self._reply(
                {"error": f"write backlog {svc.dirty} >= "
                          f"max_write_backlog {limit} — retry after "
                          f"the next snapshot swap",
                 "retry_after_s": retry_s, "dirty": svc.dirty},
                429, headers={"Retry-After": f"{retry_s:.3f}"})
        if op == "delete":
            sv = svc.delete(rows)
        else:
            sv = svc.upsert(rows, doc.get("values"))
        self._reply({"stream_version": sv, "dirty": svc.dirty})


class ClusterServeServer(ThreadingHTTPServer):
    """HTTP front-end bound to one :class:`TriclusterService`.

    Tracks in-flight requests so a graceful shutdown can *drain*: stop
    accepting (``shutdown()``), then :meth:`drain_inflight` with a
    deadline, then checkpoint/close — the SIGTERM sequence in
    ``launch/cluster_serve.py``."""
    daemon_threads = True

    def __init__(self, service: TriclusterService, addr=("127.0.0.1", 0),
                 allow_shutdown: bool = True, verbose: bool = False,
                 health_max_staleness: Optional[float] = None,
                 fault=None, max_write_backlog: int = 0, obs=None):
        super().__init__(addr, _Handler)
        self.service = service
        self.allow_shutdown = allow_shutdown
        self.verbose = verbose
        self.health_max_staleness = health_max_staleness
        self.fault = fault
        #: write backpressure bound: /upsert//delete answer 429 once
        #: ``service.dirty`` reaches this (0 = unbounded)
        self.max_write_backlog = int(max_write_backlog)
        self.throttled_writes = 0
        self._inflight = 0
        self._idle = threading.Condition()
        #: observability hub (DESIGN.md §11) — request histograms,
        #: trace spans and the slow-query ring; NULL_OBS when absent
        self.obs = obs if obs is not None else NULL_OBS
        #: hot-path instrument handles keyed ``(endpoint, status)`` —
        #: the registry's label-key lookup is too slow to re-enter per
        #: request (benign race: the registry memoises, so duplicate
        #: builders converge on the same instruments)
        self._req_instruments: dict = {}
        if self.obs.enabled:
            self.obs.metrics.register_collector(self._collect_metrics)

    def _collect_metrics(self):
        """Scrape-time rows: server-local counters, plus the service's
        stats dict when the service does not carry its own obs hub
        (shared-memory replicas) — so /stats and /metrics stay two
        views of the same numbers."""
        yield "server_throttled_writes", {}, self.throttled_writes
        yield "server_inflight", {}, self.inflight
        svc = self.service
        if getattr(svc, "obs", None) is not self.obs:
            role = ("replica" if getattr(svc, "read_only", False)
                    else "writer")
            try:
                for k, val in svc.stats().items():
                    yield f"service_{k}", {"role": role}, val
            except Exception:    # noqa: BLE001 — scrape must survive
                return           # a service mid-teardown

    @property
    def port(self) -> int:
        return self.server_address[1]

    @contextlib.contextmanager
    def track_request(self):
        with self._idle:
            self._inflight += 1
        try:
            yield
        finally:
            with self._idle:
                self._inflight -= 1
                if self._inflight == 0:
                    self._idle.notify_all()

    @property
    def inflight(self) -> int:
        with self._idle:
            return self._inflight

    def drain_inflight(self, timeout: float = 10.0) -> bool:
        """Wait (bounded) for in-flight requests to complete.  Call
        after ``shutdown()`` so no new requests are being accepted;
        returns False if stragglers remain at the deadline (the caller
        proceeds with teardown anyway — a bounded drain, not a hang)."""
        with self._idle:
            return self._idle.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout)


def make_server(service: TriclusterService, host: str = "127.0.0.1",
                port: int = 0, allow_shutdown: bool = True,
                verbose: bool = False,
                health_max_staleness: Optional[float] = None,
                fault=None,
                max_write_backlog: int = 0,
                obs=None) -> ClusterServeServer:
    """Bind (port 0 = ephemeral; read ``server.port``) without serving;
    call ``serve_forever()`` — typically on a thread — to go live."""
    return ClusterServeServer(service, (host, port),
                              allow_shutdown=allow_shutdown, verbose=verbose,
                              health_max_staleness=health_max_staleness,
                              fault=fault,
                              max_write_backlog=max_write_backlog,
                              obs=obs)


def _version_token(v):
    """Freshness token: a scalar against one service, or a per-shard
    list against a ``serve.router`` endpoint (cross-shard
    read-your-writes)."""
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return int(v)


class ClusterClient:
    """urllib client for the endpoint above (stdlib only)."""

    def __init__(self, base_url: str, timeout: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _call(self, path: str, doc: Optional[dict] = None,
              accept_statuses: tuple = ()) -> dict:
        for attempt in (0, 1):
            req = _urequest.Request(
                self.base_url + path,
                data=None if doc is None else json.dumps(doc).encode(),
                headers={"Content-Type": "application/json"},
                method="GET" if doc is None else "POST")
            try:
                with _urequest.urlopen(req, timeout=self.timeout) as r:
                    return json.loads(r.read())
            except _uerror.HTTPError as e:
                try:
                    body = json.loads(e.read())
                except Exception:
                    body = None
                if (e.code == 429 and attempt == 0
                        and 429 not in accept_statuses):
                    # write backpressure: honour Retry-After exactly
                    # once, then surface the error to the caller
                    ra = e.headers.get("Retry-After") if e.headers \
                        else None
                    if ra is None and isinstance(body, dict):
                        ra = body.get("retry_after_s")
                    try:
                        delay = min(max(float(ra), 0.0), 30.0)
                    except (TypeError, ValueError):
                        delay = 0.5
                    time.sleep(delay)
                    continue
                if e.code in accept_statuses and isinstance(body, dict):
                    body["http_status"] = e.code
                    return body
                msg = (body.get("error", str(e))
                       if isinstance(body, dict) else str(e))
                raise RuntimeError(f"{path}: {msg}") from None

    def health(self) -> dict:
        """The /health doc.  A sick backend (HTTP 503) still returns
        its body — with ``healthy: false``, the ``error`` reason and
        ``http_status: 503`` — instead of raising, so balancers and
        tests can inspect *why* a backend is being ejected."""
        return self._call("/health", accept_statuses=(503,))

    def stats(self) -> dict:
        return self._call("/stats")

    def wait_ready(self, timeout: float = 60.0, min_version: int = 1
                   ) -> dict:
        """Poll ``/health`` until the server answers with a published
        snapshot (connection errors are retried until ``timeout``)."""
        import time
        deadline = time.monotonic() + timeout
        last = None
        while time.monotonic() < deadline:
            try:
                h = self.health()
                if h.get("version", 0) >= min_version and \
                        h.get("healthy", True):
                    return h
                last = h
            except (OSError, RuntimeError) as e:
                last = e
            time.sleep(0.1)
        raise TimeoutError(f"server not ready after {timeout}s ({last!r})")

    def wait_until_fresh(self, max_staleness_s: float = 5.0,
                         timeout: float = 60.0) -> dict:
        """Block until the server's write backlog is drained
        (``dirty == 0``) and its snapshot is younger than
        ``max_staleness_s`` — the load-balancer freshness condition
        (module docstring).  Returns the satisfying /health doc."""
        import time
        deadline = time.monotonic() + timeout
        last = None
        while time.monotonic() < deadline:
            try:
                h = self.health()
                stale = h.get("staleness_s")
                if (h.get("version", 0) >= 1 and h.get("dirty", 0) == 0
                        and h.get("healthy", True)
                        and stale is not None
                        and stale <= max_staleness_s):
                    return h
                last = h
            except (OSError, RuntimeError) as e:
                last = e
            time.sleep(0.05)
        raise TimeoutError(
            f"server not fresh (≤{max_staleness_s}s, drained) after "
            f"{timeout}s ({last!r})")

    def query(self, entity: Optional[int] = None,
              mode: Optional[int] = None, signature=None, k: int = 10,
              at_least_version: Optional[int] = None,
              timeout: Optional[float] = None,
              include_components: bool = False,
              require_all: bool = False) -> dict:
        doc = {"k": k, "include_components": include_components}
        if require_all:
            # router endpoints only: refuse degraded partial coverage
            doc["require_all"] = True
        if entity is not None:
            doc["entity"] = int(entity)
        if mode is not None:
            doc["mode"] = int(mode)
        if signature is not None:
            doc["signature"] = [int(signature[0]), int(signature[1])]
        if at_least_version is not None:
            doc["at_least_version"] = _version_token(at_least_version)
            doc["timeout"] = timeout
        return self._call("/query", doc)

    def query_batch(self, entities, mode: Optional[int] = None,
                    k: int = 10,
                    at_least_version: Optional[int] = None,
                    timeout: Optional[float] = None,
                    include_components: bool = False,
                    require_all: bool = False) -> dict:
        doc = {"entities": [int(e) for e in entities], "k": k,
               "include_components": include_components}
        if require_all:
            doc["require_all"] = True
        if mode is not None:
            doc["mode"] = int(mode)
        if at_least_version is not None:
            doc["at_least_version"] = _version_token(at_least_version)
            doc["timeout"] = timeout
        return self._call("/query", doc)

    def upsert(self, rows, values=None) -> dict:
        doc = {"rows": [list(map(int, r)) for r in rows]}
        if values is not None:
            doc["values"] = [float(v) for v in values]
        return self._call("/upsert", doc)

    def delete(self, rows) -> dict:
        return self._call("/delete",
                          {"rows": [list(map(int, r)) for r in rows]})

    def refresh(self) -> dict:
        return self._call("/refresh", {})

    def shutdown(self) -> dict:
        return self._call("/shutdown", {})
