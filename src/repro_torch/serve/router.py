"""Radix-range query router: one serving plane over N shards
(DESIGN.md §8).  Port of ``repro.serve.router``: write routing runs the
port's host-numpy ``core.keys.plan_mode_key`` and
``core.runs.shard_of_rows``, so rows land in the JAX package's shards;
the router itself never touches the card.

Scaling writes past one miner reuses the partitioner the mining side
already trusts: ``core.runs.shard_of_rows`` — the top radix digit of
the mode-0 identity key, the same key-range ownership scheme
``DistributedMiner.ingest`` and the shuffle use (and the MapReduce FCA
/ distributed-triangle-counting partitioning of the related work).
Each shard is an independent writer (``TriclusterService`` + HTTP
endpoint) with optional shared-memory replica readers
(``serve.shm.ReplicaService``); this module is the thin tier in front:

* **writes** (``upsert`` / ``delete``) are partitioned by
  ``shard_of_rows`` and forwarded to the owning shards' writers;
* **queries** fan out to every shard (a cluster lives in the shard
  that owns its *generating tuples*, but its components may contain
  any entity, so entity lookups cannot be routed by entity id), each
  shard answers its local ranked top-k, and the router k-way-merges
  the per-shard lists by ``(-score, shard, rank)`` with a heap —
  top-k of the union equals the merge of per-shard top-ks;
* **freshness** is a per-shard vector: ``/refresh`` returns
  ``shard_versions`` (one snapshot version per shard) as the
  *write token*; passing that list back as ``at_least_version``
  makes every shard wait for its own component — cross-shard
  read-your-writes.  A scalar ``at_least_version`` is broadcast.

Mining stays *shard-local*: a cluster's components are computed from
the tuples its shard owns, so a logical cluster whose generating
tuples straddle a range boundary appears as per-shard parts (exactly
the per-partition aggregation trade-off of the MapReduce scheme).
Merged hits are deduplicated by signature (best score wins) so the
plane still answers with one hit per cluster identity.

The router speaks the same HTTP/JSON dialect as ``serve.protocol`` —
``ClusterClient`` works unchanged against a router endpoint — and
keeps per-worker-thread persistent connections to every backend, so
its fan-out adds no per-query TCP setup.

**Failure handling** (DESIGN.md §9).  Every backend endpoint carries a
:class:`CircuitBreaker`; per-shard calls retry with capped exponential
backoff under one per-request deadline budget, migrating off ejected
replicas, while a background loop re-probes open circuits with
/health.  When a shard stays unreachable past its budget, queries
*degrade*: the router merges the live shards and stamps the response
``degraded: true`` with a ``coverage`` list of answering shards —
never a 502 for a partial outage (pass ``require_all`` to restore
all-or-nothing).  Writes are never degraded: a partially-applied
scatter would silently lose ranges, so write failures still propagate
after their retry budget.
"""
from __future__ import annotations

import heapq
import itertools
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence

import http.client

import numpy as np

from ..obs import NULL_OBS, TRACE_HEADER, parse_trace_header
from ..obs.metrics import Histogram
from .protocol import handle_obs_get


class GatewayTimeout(TimeoutError):
    """HTTP 504 from a backend: the backend is *alive* — it answered —
    but could not satisfy the freshness token in time.  Distinct from a
    transport ``TimeoutError`` so the retry/circuit-breaker layer does
    not punish a live backend for a client-requested wait."""


class CircuitBreaker:
    """Per-endpoint ejection: ``threshold`` consecutive transport
    failures open the circuit for ``cooldown`` seconds (doubling per
    re-trip, capped), after which exactly one caller at a time gets a
    half-open probe slot; one success closes it.  Thread-safe — one
    breaker per endpoint, shared by all router worker threads."""

    def __init__(self, threshold: int = 3, cooldown: float = 0.5,
                 cooldown_max: float = 8.0):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.cooldown_max = float(cooldown_max)
        self._lock = threading.Lock()
        self._fails = 0
        self._cd = self.cooldown
        self._open_until = 0.0
        self.trips = 0

    def allow(self) -> bool:
        """May a request be sent now?  True while closed; when open,
        True only for the first caller past the cooldown (the half-open
        probe — the slot is pushed forward so concurrent callers do not
        stampede a struggling backend)."""
        with self._lock:
            if self._fails < self.threshold:
                return True
            now = time.monotonic()
            if now >= self._open_until:
                self._open_until = now + self._cd
                return True
            return False

    def probe_due(self) -> bool:
        """Like :meth:`allow` but only for *open* circuits — the
        background re-probe loop's gate (never touches healthy
        endpoints)."""
        with self._lock:
            if self._fails < self.threshold:
                return False
            now = time.monotonic()
            if now < self._open_until:
                return False
            self._open_until = now + self._cd
            return True

    def ok(self) -> None:
        with self._lock:
            self._fails = 0
            self._cd = self.cooldown

    def fail(self) -> None:
        with self._lock:
            self._fails += 1
            if self._fails >= self.threshold:
                if self._fails == self.threshold:
                    self.trips += 1
                self._open_until = time.monotonic() + self._cd
                self._cd = min(self._cd * 2, self.cooldown_max)

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._fails >= self.threshold

    def state(self) -> str:
        with self._lock:
            if self._fails < self.threshold:
                return "closed"
            return ("half-open"
                    if time.monotonic() >= self._open_until else "open")


class PooledClient:
    """Minimal JSON-over-HTTP client with one persistent connection per
    calling thread (stdlib ``http.client``).  A request failing on a
    *reused* keep-alive socket (backend restarted between requests:
    ``ConnectionResetError`` / ``BadStatusLine`` / a torn empty
    response) is retried exactly once on a fresh connection before the
    backend is declared down; transport timeouts are deadlines and are
    never retried here.  Carries the endpoint's :class:`CircuitBreaker`
    (state shared across all threads)."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 breaker: Optional[CircuitBreaker] = None):
        base = base_url.rstrip("/")
        if base.startswith("http://"):
            base = base[len("http://"):]
        self.base_url = "http://" + base
        host, _, port = base.partition(":")
        self.host, self.port = host, int(port or 80)
        self.timeout = timeout
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self._local = threading.local()

    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = http.client.HTTPConnection(self.host, self.port,
                                           timeout=self.timeout)
            self._local.conn = c
        return c

    def _drop(self) -> None:
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
        self._local.conn = None

    def call(self, path: str, doc: Optional[dict] = None,
             timeout: Optional[float] = None,
             headers: Optional[dict] = None) -> dict:
        body = None if doc is None else json.dumps(doc).encode()
        method = "GET" if doc is None else "POST"
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        t = self.timeout if timeout is None else max(0.01, float(timeout))
        for attempt in (0, 1):
            try:
                c = self._conn()
                if c.timeout != t:
                    c.timeout = t
                    if c.sock is not None:
                        c.sock.settimeout(t)
                c.request(method, path, body=body, headers=hdrs)
                r = c.getresponse()
                data = r.read()
                break
            except TimeoutError:
                # a deadline, not a stale socket: retrying would double
                # the caller's wait — surface it
                self._drop()
                raise
            except (http.client.HTTPException, ConnectionError,
                    OSError):
                self._drop()
                if attempt:
                    raise
        out = json.loads(data) if data else {}
        if r.status == 504:
            raise GatewayTimeout(out.get("error", "gateway timeout"))
        if r.status >= 400:
            raise RuntimeError(f"{path}: "
                               f"{out.get('error', f'HTTP {r.status}')}")
        return out


class Shard:
    """One radix range: a writer endpoint plus its replica readers.
    Queries round-robin over the replicas whose circuit breakers admit
    traffic (falling back to the writer when none do, and to the
    round-robin pick as a last resort — a fully-ejected shard still
    gets its half-open probes through); writes always go to the
    writer."""

    def __init__(self, writer: str, replicas: Sequence[str] = (),
                 timeout: float = 30.0):
        self.writer = PooledClient(writer, timeout)
        self.replicas = [PooledClient(u, timeout) for u in replicas]
        self._rr = itertools.count()

    def reader(self) -> PooledClient:
        cands = self.replicas if self.replicas else [self.writer]
        start = next(self._rr)
        for j in range(len(cands)):
            c = cands[(start + j) % len(cands)]
            if c.breaker.allow():
                return c
        if self.replicas and self.writer.breaker.allow():
            return self.writer
        return cands[start % len(cands)]

    def endpoints(self) -> List[PooledClient]:
        return [self.writer, *self.replicas]


def _merge_hits(per_shard: List[list], k: int) -> list:
    """K-way merge of per-shard ranked hit lists; global best-first by
    ``(-score, shard, rank)``, deduplicated by signature (first — i.e.
    best — occurrence wins), truncated to ``k``."""
    streams = [((-h["score"], s, i), h)
               for s, hits in enumerate(per_shard)
               for i, h in enumerate(hits)]
    out, seen = [], set()
    for _, h in heapq.nsmallest(len(streams), streams, key=lambda t: t[0]):
        sig = tuple(h["signature"])
        if sig in seen:
            continue
        seen.add(sig)
        out.append(h)
        if len(out) >= k:
            break
    return out


class RouterService:
    """Fan-out / merge logic over a list of :class:`Shard`; the HTTP
    front-end (:func:`make_router_server`) is a thin JSON shim over
    these methods, and they are equally usable in-process."""

    def __init__(self, shards: Sequence[Shard], sizes=None,
                 timeout: float = 30.0, retry_base: float = 0.05,
                 retry_cap: float = 0.5, probe_interval: float = 0.25,
                 probe_timeout: float = 1.0, obs=None):
        if not shards:
            raise ValueError("router needs at least one shard")
        self.shards = list(shards)
        self.timeout = timeout
        self.obs = obs if obs is not None else NULL_OBS
        # per-endpoint handler latency lives in plain always-on
        # histograms (not the registry): resilience_stats() must stay
        # auditable even when the plane runs without --metrics
        self._endpoint_hist: dict = {}
        self._ep_lock = threading.Lock()
        #: hot-path registry-instrument handles keyed ``(endpoint,
        #: status)`` — the per-request label lookup is too slow to
        #: re-enter in the handler (benign race: the registry memoises,
        #: so duplicate builders converge on the same instruments)
        self._req_instruments: dict = {}
        if self.obs.enabled:
            self.obs.metrics.register_collector(self._collect_metrics)
        #: capped exponential backoff between per-shard retries, all
        #: under one per-request deadline budget (``timeout``)
        self.retry_base = float(retry_base)
        self.retry_cap = float(retry_cap)
        self.probe_timeout = float(probe_timeout)
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, len(self.shards) * 2),
            thread_name_prefix="router-fan")
        self._sizes = None if sizes is None else tuple(int(s)
                                                       for s in sizes)
        self._id_plan = None
        self._lock = threading.Lock()
        self._stats = {"retries": 0, "degraded_responses": 0,
                       "shard_failures": 0, "probes": 0,
                       "probe_recoveries": 0}
        # background re-probe: open circuits get /health probes so an
        # ejected backend rejoins without waiting for query traffic to
        # half-open it
        self.probe_interval = float(probe_interval)
        self._stop_probe = threading.Event()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, name="router-probe", daemon=True)
        if self.probe_interval > 0:
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        while not self._stop_probe.wait(max(self.probe_interval, 0.01)):
            for sh in self.shards:
                for c in sh.endpoints():
                    if not c.breaker.probe_due():
                        continue
                    self._stats["probes"] += 1
                    try:
                        c.call("/health", timeout=self.probe_timeout)
                        c.breaker.ok()
                        self._stats["probe_recoveries"] += 1
                    except Exception:        # noqa: BLE001 — stays open
                        c.breaker.fail()

    # -- observability -------------------------------------------------------

    def observe_endpoint(self, endpoint: str, ms: float) -> None:
        """Record one handler latency for ``endpoint`` — always on, so
        the per-endpoint latency the handler measures actually reaches
        :meth:`resilience_stats` (it used to be computed and thrown
        away)."""
        h = self._endpoint_hist.get(endpoint)
        if h is None:
            with self._ep_lock:
                h = self._endpoint_hist.setdefault(endpoint, Histogram())
        h.observe(ms)

    def _collect_metrics(self):
        """Scrape-time fold of the router's stats dict and breaker
        states into the registry (one source of truth: `/stats`,
        `/metrics` render the same counters)."""
        for k, v in self._stats.items():
            yield f"router_{k}", {}, v
        for s, sh in enumerate(self.shards):
            for c in sh.endpoints():
                lbl = {"shard": s, "endpoint": c.base_url}
                yield "router_breaker_open", lbl, int(c.breaker.is_open)
                yield "router_breaker_trips", lbl, c.breaker.trips
        with self._ep_lock:
            hists = dict(self._endpoint_hist)
        for ep, h in hists.items():
            lbl = {"endpoint": ep}
            yield "router_endpoint_latency_ms_count", lbl, h.count
            yield "router_endpoint_latency_ms_p50", lbl, h.quantile(0.5)
            yield "router_endpoint_latency_ms_p99", lbl, h.quantile(0.99)

    # -- partitioning --------------------------------------------------------

    @property
    def sizes(self):
        if self._sizes is None:
            st = self.shards[0].writer.call("/stats")
            self._sizes = tuple(int(s) for s in st["sizes"])
        return self._sizes

    def shard_of(self, rows) -> np.ndarray:
        """Owning shard per tuple row — ``core.runs.shard_of_rows`` on
        the mode-0 identity key's top radix digit (the partitioner the
        shuffle and ``DistributedMiner`` already use)."""
        if self._id_plan is None:
            with self._lock:
                if self._id_plan is None:
                    from ..core import keys as K
                    self._id_plan = K.plan_mode_key(self.sizes, 0,
                                                    with_values=False)
        from ..core import runs as RS
        return RS.shard_of_rows(np.asarray(rows, np.int64), self._id_plan,
                                len(self.shards))

    # -- fan-out helpers -----------------------------------------------------

    def _fan(self, calls) -> list:
        """Run ``(client, path, doc)`` triples concurrently; returns the
        responses in order.  Any backend failure propagates (the plane
        answers fully or not at all — partial answers would silently
        drop ranges)."""
        futs = [self._pool.submit(c.call, path, doc)
                for c, path, doc in calls]
        return [f.result(timeout=self.timeout + 5) for f in futs]

    def _retrying(self, pick, path: str, doc, budget: float,
                  trace=(None, None), shard=None) -> dict:
        """One logical backend call under a deadline budget: transport
        failures retry with capped exponential backoff against whatever
        endpoint ``pick()`` currently favours (breaker-aware, so
        retries migrate off an ejected replica).  A :class:`GatewayTimeout`
        (HTTP 504 — live backend, unmet freshness token) and HTTP-level
        errors propagate immediately: the backend answered.

        When tracing is on, every *attempt* gets its own span (child of
        ``trace``) whose id rides the :data:`TRACE_HEADER` to the
        backend — the failed attempts are part of the story."""
        deadline = time.monotonic() + budget
        delay = self.retry_base
        last: Optional[BaseException] = None
        tracer = self.obs.tracer if self.obs.enabled else None
        attempt = 0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise (last if last is not None
                       else TimeoutError(f"{path}: retry budget "
                                         f"({budget:.1f}s) exhausted"))
            c = pick()
            sp = headers = None
            if tracer is not None:
                sp = tracer.start("router.attempt", trace_id=trace[0],
                                  parent_id=trace[1], path=path,
                                  attempt=attempt, endpoint=c.base_url)
                if shard is not None:
                    sp.set("shard", shard)
                headers = {TRACE_HEADER: sp.header()}
            attempt += 1
            try:
                # per-attempt timeout: the endpoint's own bound, capped
                # by the remaining budget — one hung backend must not
                # swallow the whole deadline in a single attempt
                out = c.call(path, doc, timeout=min(remaining, c.timeout),
                             headers=headers)
                c.breaker.ok()
                if sp is not None:
                    sp.set("outcome", "ok").finish()
                return out
            except GatewayTimeout as e:
                c.breaker.ok()               # it answered — alive
                if sp is not None:
                    sp.set("outcome", "gateway_timeout")
                    sp.error(str(e)).finish()
                raise
            except RuntimeError as e:
                c.breaker.ok()               # HTTP error from a live
                if sp is not None:           # backend, not a transport
                    sp.set("outcome", "http_error")
                    sp.error(str(e)).finish()
                raise
            except (TimeoutError, ConnectionError,
                    http.client.HTTPException, OSError) as e:
                c.breaker.fail()
                last = e
                if sp is not None:
                    sp.set("outcome", "retry").error(repr(e)).finish()
            if time.monotonic() + delay >= deadline:
                raise last
            self._stats["retries"] += 1
            time.sleep(delay)
            delay = min(delay * 2, self.retry_cap)

    def _tokens(self, at_least_version) -> List[Optional[int]]:
        n = len(self.shards)
        if at_least_version is None:
            return [None] * n
        if isinstance(at_least_version, (list, tuple)):
            if len(at_least_version) != n:
                raise ValueError(
                    f"at_least_version list must have one entry per "
                    f"shard ({n}), got {len(at_least_version)}")
            return [int(v) for v in at_least_version]
        return [int(at_least_version)] * n

    # -- reads ---------------------------------------------------------------

    def query(self, entity=None, mode=None, signature=None, k: int = 10,
              at_least_version=None, timeout=None,
              include_components: bool = False,
              require_all: bool = False, trace=(None, None)) -> dict:
        doc = {"k": int(k), "include_components": bool(include_components)}
        if entity is not None:
            doc["entity"] = int(entity)
        if mode is not None:
            doc["mode"] = int(mode)
        if signature is not None:
            doc["signature"] = [int(signature[0]), int(signature[1])]
        res = self._fan_query(doc, at_least_version, timeout, require_all,
                              trace)
        hits = _merge_hits([r["hits"] for r in res if r is not None],
                           int(k))
        return self._doc(res, hits)

    def query_batch(self, entities, mode=None, k: int = 10,
                    at_least_version=None, timeout=None,
                    include_components: bool = False,
                    require_all: bool = False,
                    trace=(None, None)) -> dict:
        doc = {"entities": [int(e) for e in entities], "k": int(k),
               "include_components": bool(include_components)}
        if mode is not None:
            doc["mode"] = int(mode)
        res = self._fan_query(doc, at_least_version, timeout, require_all,
                              trace)
        hits = [_merge_hits([r["hits"][i] for r in res if r is not None],
                            int(k))
                for i in range(len(doc["entities"]))]
        return self._doc(res, hits)

    def _shard_query(self, s: int, sh: Shard, doc: dict, budget: float,
                     trace=(None, None)) -> dict:
        """One shard's slice of a fan-out, wrapped in a ``router.shard``
        span that records which endpoints the circuit breakers were
        holding ejected when the shard was dispatched."""
        if not self.obs.enabled:
            return self._retrying(sh.reader, "/query", doc, budget)
        # is_open (not allow()) — allow() consumes the half-open probe
        # slot, and observability must never perturb breaker behaviour
        skipped = [c.base_url for c in sh.endpoints() if c.breaker.is_open]
        sp = self.obs.tracer.start("router.shard", trace_id=trace[0],
                                   parent_id=trace[1], shard=s)
        if skipped:
            sp.set("breakers_open", skipped)
            self.obs.metrics.counter("router_breaker_skips",
                                     shard=s).inc(len(skipped))
        try:
            out = self._retrying(sh.reader, "/query", doc, budget,
                                 trace=(sp.trace_id, sp.span_id), shard=s)
            sp.set("version", out.get("version"))
            return out
        except BaseException as e:
            sp.error(repr(e))
            raise
        finally:
            sp.finish()

    def _fan_query(self, doc: dict, at_least_version, timeout,
                   require_all: bool = False,
                   trace=(None, None)) -> list:
        """Fan a /query to every shard with per-shard retry under the
        deadline budget.  Returns one response per shard, ``None`` for
        a shard whose retry budget was exhausted — **degraded partial
        results**, unless ``require_all`` (then the first shard failure
        propagates, restoring all-or-nothing).  Every shard down is
        always an error; a live shard's 504 (unmet freshness token)
        always propagates — the token was a promise."""
        tokens = self._tokens(at_least_version)
        budget = float(timeout) if timeout is not None else self.timeout
        futs = []
        for s, (sh, tok) in enumerate(zip(self.shards, tokens)):
            d = dict(doc)
            if tok is not None:
                d["at_least_version"] = tok
                d["timeout"] = timeout
            futs.append(self._pool.submit(
                self._shard_query, s, sh, d, budget, trace))
        res: List[Optional[dict]] = []
        first_err: Optional[BaseException] = None
        for s, f in enumerate(futs):
            try:
                res.append(f.result(timeout=budget + 5))
            except GatewayTimeout:
                raise
            except Exception as e:           # noqa: BLE001 — transport
                self._stats["shard_failures"] += 1
                if self.obs.enabled:
                    # the drop leaves a mark in the trace: a degraded
                    # answer is reconstructable after the fact
                    drop = self.obs.tracer.start(
                        "router.degraded_drop", trace_id=trace[0],
                        parent_id=trace[1], shard=s)
                    drop.error(repr(e)).finish()
                if first_err is None:
                    first_err = e
                res.append(None)
        if all(r is None for r in res):
            raise RuntimeError(f"all {len(self.shards)} shards "
                               f"unreachable: {first_err!r}")
        if require_all and first_err is not None:
            raise first_err
        return res

    def _doc(self, res: list, hits) -> dict:
        """Merge per-shard responses (``None`` = shard down) into the
        router doc.  ``coverage`` lists the shards that answered;
        ``degraded`` flags a partial answer; a down shard reports
        version 0 in ``shard_versions`` (no read-your-writes guarantee
        for its range)."""
        coverage = [s for s, r in enumerate(res) if r is not None]
        live = [r for r in res if r is not None]
        degraded = len(coverage) < len(res)
        if degraded:
            self._stats["degraded_responses"] += 1
        vers = [0 if r is None else int(r["version"]) for r in res]
        return {"version": min(int(r["version"]) for r in live),
                "shard_versions": vers,
                "stream_version": min(int(r["stream_version"])
                                      for r in live),
                "hits": hits, "degraded": degraded, "coverage": coverage}

    # -- writes --------------------------------------------------------------

    def _scatter(self, op: str, rows, values=None,
                 trace=(None, None)) -> dict:
        rows = [list(map(int, r)) for r in rows]
        if not rows:
            raise ValueError(f"/{op} needs non-empty 'rows'")
        owner = self.shard_of(rows)
        calls, touched = [], []
        for s, sh in enumerate(self.shards):
            idx = np.nonzero(owner == s)[0]
            if not idx.size:
                continue
            doc = {"rows": [rows[int(i)] for i in idx]}
            if values is not None:
                doc["values"] = [float(values[int(i)]) for i in idx]
            calls.append((sh.writer, f"/{op}", doc))
            touched.append(s)
        # writes stay all-or-nothing — a partially-applied scatter would
        # silently lose ranges — but each shard's call retries under the
        # deadline budget, so a writer mid-restart absorbs the write
        # once its supervisor brings it back
        futs = [self._pool.submit(self._retrying,
                                  (lambda c=c: c), path, doc, self.timeout,
                                  trace, s)
                for (c, path, doc), s in zip(calls, touched)]
        res = [f.result(timeout=self.timeout + 5) for f in futs]
        svs = [0] * len(self.shards)
        dirty = [0] * len(self.shards)
        for s, r in zip(touched, res):
            svs[s] = int(r["stream_version"])
            dirty[s] = int(r.get("dirty", 0))
        return {"shards": touched, "stream_versions": svs,
                "dirty": sum(dirty)}

    def upsert(self, rows, values=None, trace=(None, None)) -> dict:
        return self._scatter("upsert", rows, values, trace)

    def delete(self, rows, trace=(None, None)) -> dict:
        return self._scatter("delete", rows, trace=trace)

    def refresh(self) -> dict:
        """Synchronous re-mine + swap on every shard; the returned
        ``shard_versions`` list is the cross-shard write token."""
        res = self._fan([(sh.writer, "/refresh", {})
                         for sh in self.shards])
        vers = [int(r["version"]) for r in res]
        return {"version": min(vers), "shard_versions": vers,
                "clusters": sum(int(r["clusters"]) for r in res)}

    # -- health / lifecycle --------------------------------------------------

    def health(self) -> dict:
        """Plane health, tolerant of down backends: an unreachable
        endpoint becomes a ``down`` entry instead of failing the whole
        doc (a router that 502s its own /health while a shard restarts
        would get *itself* ejected).  Raises only when every endpoint
        of every shard is unreachable."""
        clients = [(s, c) for s, sh in enumerate(self.shards)
                   for c in sh.endpoints()]
        futs = [self._pool.submit(c.call, "/health", None,
                                  min(self.probe_timeout * 2,
                                      self.timeout))
                for _, c in clients]
        docs: List[Optional[dict]] = []
        down: List[str] = []
        for (s, c), f in zip(clients, futs):
            try:
                docs.append(f.result(timeout=self.timeout + 5))
            except Exception:                # noqa: BLE001 — down
                docs.append(None)
                down.append(c.base_url)
        per_shard, i = [], 0
        for sh in self.shards:
            n = 1 + len(sh.replicas)
            per_shard.append([d for d in docs[i:i + n] if d is not None])
            i += n
        live = [ends for ends in per_shard if ends]
        if not live:
            raise RuntimeError("all backends unreachable")
        vers = [min(int(e["version"]) for e in ends) if ends else 0
                for ends in per_shard]
        stale = [e.get("staleness_s") for ends in per_shard for e in ends]
        stale = [s for s in stale if s is not None]
        return {"role": "router",
                "version": min(v for v, ends in zip(vers, per_shard)
                               if ends),
                "shard_versions": vers,
                "stream_version": min(int(ends[0]["stream_version"])
                                      for ends in live),
                "clusters": sum(int(ends[0]["clusters"])
                                for ends in live),
                "dirty": sum(int(ends[0]["dirty"]) for ends in live),
                "dirty_clusters": sum(int(ends[0].get("dirty_clusters", 0))
                                      for ends in live),
                "staleness_s": max(stale) if stale else None,
                "shards": len(self.shards),
                "replicas": [len(sh.replicas) for sh in self.shards],
                "down": down,
                "coverage": [s for s, ends in enumerate(per_shard)
                             if ends],
                "degraded": bool(down)}

    def resilience_stats(self) -> dict:
        """Router-local failure-handling counters + per-endpoint
        breaker states (no backend round-trips), plus the per-endpoint
        handler-latency digests that make breaker decisions auditable
        after the fact."""
        out = dict(self._stats)
        out["breakers"] = [
            {"shard": s, "endpoint": c.base_url,
             "state": c.breaker.state(), "trips": c.breaker.trips}
            for s, sh in enumerate(self.shards)
            for c in sh.endpoints()]
        with self._ep_lock:
            hists = dict(self._endpoint_hist)
        out["endpoint_latency_ms"] = {
            ep: {"count": h.count, "p50": h.quantile(0.5),
                 "p99": h.quantile(0.99)}
            for ep, h in sorted(hists.items())}
        return out

    def stats(self) -> dict:
        res = self._fan([(sh.writer, "/stats", None)
                         for sh in self.shards])
        out = self.health()
        out["sizes"] = res[0].get("sizes")
        out["shard_stats"] = res
        out["resilience"] = self.resilience_stats()
        return out

    def shutdown_backends(self) -> None:
        """Best-effort fan-out /shutdown to every backend (replicas
        first, then writers)."""
        for sh in self.shards:
            for c in [*sh.replicas, sh.writer]:
                try:
                    c.call("/shutdown", {})
                except Exception:            # noqa: BLE001 — teardown
                    pass

    def close(self) -> None:
        self._stop_probe.set()
        if self._probe_thread.is_alive():
            self._probe_thread.join(timeout=5)
        self._pool.shutdown(wait=False)


class _RouterHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _reply(self, doc: dict, status: int = 200) -> None:
        self._status = status            # for the request instruments
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        router: RouterService = self.server.router
        try:
            if self.path == "/health":
                self._reply(router.health())
            elif self.path == "/stats":
                self._reply(router.stats())
            elif handle_obs_get(self, router.obs):
                pass
            else:
                self._reply({"error": f"unknown path {self.path}"}, 404)
        except TimeoutError as e:
            self._reply({"error": str(e)}, 504)
        except (RuntimeError, OSError) as e:
            self._reply({"error": f"backend failure: {e}"}, 502)

    def do_POST(self):
        t_recv = time.perf_counter()
        router: RouterService = self.server.router
        obs = router.obs
        try:
            n = int(self.headers.get("Content-Length") or 0)
            doc = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            return self._reply({"error": f"bad JSON body: {e}"}, 400)
        ep = (self.path if self.path in
              ("/query", "/upsert", "/delete", "/refresh", "/shutdown")
              else "other")
        sp = None
        trace = (None, None)
        if obs.enabled:
            tid, pid = parse_trace_header(self.headers.get(TRACE_HEADER))
            sp = obs.tracer.start(f"router{self.path}", trace_id=tid,
                                  parent_id=pid, role="router")
            trace = (sp.trace_id, sp.span_id)
        self._status = 200
        coverage = None
        t0 = time.perf_counter()
        try:
            if self.path == "/query":
                if "entities" in doc:
                    out = router.query_batch(
                        doc["entities"], mode=doc.get("mode"),
                        k=int(doc.get("k", 10)),
                        at_least_version=doc.get("at_least_version"),
                        timeout=doc.get("timeout"),
                        include_components=bool(
                            doc.get("include_components", False)),
                        require_all=bool(doc.get("require_all", False)),
                        trace=trace)
                else:
                    sig = doc.get("signature")
                    out = router.query(
                        entity=doc.get("entity"), mode=doc.get("mode"),
                        signature=(None if sig is None
                                   else (int(sig[0]), int(sig[1]))),
                        k=int(doc.get("k", 10)),
                        at_least_version=doc.get("at_least_version"),
                        timeout=doc.get("timeout"),
                        include_components=bool(
                            doc.get("include_components", False)),
                        require_all=bool(doc.get("require_all", False)),
                        trace=trace)
                out["server_ms"] = (time.perf_counter() - t0) * 1e3
                coverage = out.get("coverage")
                if sp is not None and sp.trace_id:
                    out["trace_id"] = sp.trace_id
                self._reply(out)
            elif self.path == "/upsert":
                self._reply(router.upsert(doc.get("rows") or [],
                                          doc.get("values"), trace=trace))
            elif self.path == "/delete":
                self._reply(router.delete(doc.get("rows") or [],
                                          trace=trace))
            elif self.path == "/refresh":
                self._reply(router.refresh())
            elif self.path == "/shutdown":
                if not getattr(self.server, "allow_shutdown", True):
                    return self._reply({"error": "shutdown disabled"}, 403)
                if getattr(self.server, "cascade_shutdown", False) or \
                        doc.get("cascade"):
                    router.shutdown_backends()
                self._reply({"ok": True})
                threading.Thread(target=self.server.shutdown,
                                 daemon=True).start()
            else:
                self._reply({"error": f"unknown path {self.path}"}, 404)
        except TimeoutError as e:
            self._reply({"error": str(e)}, 504)
        except (ValueError, KeyError, IndexError, OverflowError,
                TypeError) as e:
            self._reply({"error": str(e)}, 400)
        except (RuntimeError, OSError) as e:
            self._reply({"error": f"backend failure: {e}"}, 502)
        finally:
            now = time.perf_counter()
            handler_ms = (now - t0) * 1e3
            total_ms = (now - t_recv) * 1e3
            status = getattr(self, "_status", 200)
            # the fix for the dropped server_ms: handler latency now
            # reaches resilience_stats() through the always-on digests
            router.observe_endpoint(ep, handler_ms)
            if sp is not None:
                sp.set("status", status)
                if coverage is not None:
                    sp.set("coverage", coverage)
                if status >= 500:
                    sp.error(f"HTTP {status}")
                sp.finish()
            if obs.enabled:
                pair = router._req_instruments.get((ep, status))
                if pair is None:
                    pair = (obs.metrics.histogram("router_request_ms",
                                                  endpoint=ep),
                            obs.metrics.counter("router_requests_total",
                                                endpoint=ep,
                                                code=str(status)))
                    router._req_instruments[(ep, status)] = pair
                pair[0].observe(handler_ms)
                pair[1].inc()
                if ep == "/query":
                    obs.slow.record(
                        ep, total_ms, handler_ms=handler_ms,
                        wait_ms=total_ms - handler_ms,
                        trace_id=sp.trace_id if sp is not None else "",
                        coverage=coverage)


class RouterServer(ThreadingHTTPServer):
    """HTTP front-end bound to one :class:`RouterService`."""
    daemon_threads = True

    def __init__(self, router: RouterService, addr=("127.0.0.1", 0),
                 allow_shutdown: bool = True,
                 cascade_shutdown: bool = False, verbose: bool = False):
        super().__init__(addr, _RouterHandler)
        self.router = router
        self.allow_shutdown = allow_shutdown
        self.cascade_shutdown = cascade_shutdown
        self.verbose = verbose

    @property
    def port(self) -> int:
        return self.server_address[1]


def make_router_server(router: RouterService, host: str = "127.0.0.1",
                       port: int = 0, allow_shutdown: bool = True,
                       cascade_shutdown: bool = False,
                       verbose: bool = False) -> RouterServer:
    """Bind (port 0 = ephemeral; read ``server.port``) without serving;
    call ``serve_forever()`` — typically on a thread — to go live."""
    return RouterServer(router, (host, port),
                        allow_shutdown=allow_shutdown,
                        cascade_shutdown=cascade_shutdown,
                        verbose=verbose)
