"""Cluster-serving driver of the port: a long-lived HTTP query service
over a live mining stream (DESIGN.md §8).  The twin of
``repro.launch.cluster_serve``, with its flags, plus ``--device``: the
writers mine there (default ``cuda``, which raises without a card, as
the port's other entry points do; ``--device cpu`` runs the kernels'
plain versions).  Only writers take the device: replicas and the
router read host arrays and never create a CUDA context.

Server:  ``python -m repro_torch.launch.cluster_serve --dataset imdb
--port 8787`` — preloads the dataset into a :class:`TriclusterService`
(streaming by default, ``--backend distributed`` for per-shard run
stores), publishes the first snapshot, and serves queries while the
background thread re-mines on writes.

Sharded plane:  ``--shards 2 --replicas 2`` spawns (per shard) one
writer process — which preloads only the radix range it owns
(``core.runs.shard_of_rows`` on the mode-0 identity key) and mirrors
every snapshot into shared memory — plus N zero-copy replica reader
processes (``serve.shm.ReplicaService``; no device), then fronts the
whole topology with a ``serve.router`` endpoint on ``--port``.  The
router speaks the same protocol, so clients are unchanged.  Children
are spawned (``fork`` after CUDA is unsafe), so a script that starts a
plane in-process keeps a ``__main__`` guard.

Smoke client:  ``python -m repro_torch.launch.cluster_serve
--smoke-client --port-file PATH`` — drives a running server through the
whole surface (scalar, batch, top-k and signature queries; an upsert; a
forced refresh asserting the version advanced; clean shutdown).
Against a router it additionally verifies cross-shard
read-your-writes: an upsert spanning every shard, then a query pinned
to the per-shard ``shard_versions`` write token.  Exits non-zero on
any violation — this is the CI serve-smoke step.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile
import threading
import time


def _load_fault_plan(spec: str):
    """``--fault-plan`` value: inline JSON, or a path (optionally
    ``@``-prefixed) to a JSON file.  Returns a FaultPlan or None."""
    if not spec:
        return None
    if spec.startswith("@"):
        spec = spec[1:]
    if os.path.exists(spec):
        with open(spec) as f:
            spec = f.read()
    from ..serve.faults import FaultPlan
    return FaultPlan.from_json(spec)


def _make_obs(enabled: bool, slow_query_ms: float, service: str):
    """One per-process observability hub (``repro.obs.Obs``) or None.
    Each process of a topology builds its own — metrics and spans are
    process-local; the trace id stitches them back together."""
    if not enabled:
        return None
    from ..obs import Obs
    return Obs.create(service=service, slow_query_ms=slow_query_ms)


def _install_sigterm(server, flag: dict) -> None:
    """Graceful SIGTERM: mark the shutdown as supervisor-driven (shm
    segments are *kept* so a successor can adopt the epoch watermark)
    and unblock ``serve_forever`` — the caller's ``finally`` then
    drains, checkpoints and closes."""
    def _handler(signum, frame):
        flag["unlink"] = False
        threading.Thread(target=server.shutdown, daemon=True).start()
    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:                       # not the main thread
        pass


def _serve(args) -> int:
    from ..serve.protocol import make_server
    from ..serve.ranking import RankingPolicy
    from ..serve.service import TriclusterService
    from .tricluster import load_dataset

    ctx = load_dataset(args.dataset, args.n_tuples, args.seed)
    policy = RankingPolicy(w_density=args.w_density,
                           w_volume=args.w_volume,
                           w_recency=args.w_recency)
    plan = _load_fault_plan(args.fault_plan)
    inj = None if plan is None else plan.for_component("writer", 0)
    obs = _make_obs(args.metrics, args.slow_query_ms, "writer")
    svc = TriclusterService(
        ctx.sizes, backend=args.backend, theta=args.theta,
        delta=args.delta, rho_min=args.rho_min, minsup=args.minsup,
        refresh_interval=args.refresh_interval,
        dirty_threshold=args.dirty_threshold, policy=policy,
        delta_index=not args.no_delta_index, seed=args.seed or 0x5EED,
        recover_dir=args.recover_dir or None,
        checkpoint_every=args.checkpoint_every,
        scrub_interval=args.scrub_interval, fault=inj, obs=obs,
        device=args.device)
    n = ctx.tuples.shape[0]
    if not svc.recovered:                    # a recovered store already
        step = -(-n // max(1, args.preload_chunks))  # holds the data
        for lo in range(0, n, step):
            svc.add(ctx.tuples[lo:lo + step],
                    None if ctx.values is None or args.delta is None
                    else ctx.values[lo:lo + step])
    svc.start()
    server = make_server(svc, host=args.host, port=args.port,
                         allow_shutdown=not args.no_shutdown,
                         verbose=args.verbose,
                         health_max_staleness=(args.health_max_staleness
                                               or None),
                         max_write_backlog=args.max_write_backlog,
                         fault=inj, obs=obs)
    flag = {"unlink": True}
    _install_sigterm(server, flag)
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(server.port))
    print(f"[cluster-serve] dataset={args.dataset} sizes={ctx.sizes} "
          f"|I|={n} backend={args.backend} device={svc.device} "
          f"version={svc.version} "
          f"clusters={svc.stats()['clusters']}", flush=True)
    print(f"[cluster-serve] listening on http://{args.host}:{server.port}",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.drain_inflight(timeout=args.drain_timeout)
        server.server_close()
        try:
            svc.final_checkpoint()
        except Exception:                    # noqa: BLE001 — teardown
            pass
        svc.stop()
        print("[cluster-serve] stopped", flush=True)
    return 0


def _wait_port_file(path: str, timeout: float) -> int:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            time.sleep(0.1)
    raise TimeoutError(f"no port in {path} after {timeout}s")


def _stable_port(cfg: dict) -> int:
    """A restarted child must come back on the port the router already
    holds a client for — reuse the port recorded by the previous
    incarnation (0 = first boot, ephemeral)."""
    try:
        with open(cfg["port_file"]) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return 0


def _bind_server(make, port: int, retries: int = 40,
                 delay: float = 0.25):
    """Bind, retrying EADDRINUSE when rebinding a predecessor's port —
    its socket may linger for a moment after the crash."""
    while True:
        try:
            return make(port)
        except OSError:
            if port == 0 or retries <= 0:
                raise
            retries -= 1
            time.sleep(delay)


def _child_injector(cfg: dict, role: str):
    if not cfg.get("fault_plan"):
        return None
    from ..serve.faults import FaultPlan
    return FaultPlan.from_json(cfg["fault_plan"]).for_component(
        role, cfg.get("shard", 0), cfg.get("replica", -1))


def _child_writer(cfg: dict) -> None:
    """Spawn target: one shard's writer — loads the dataset, keeps only
    the radix range this shard owns, publishes snapshots to shared
    memory (when replicas attach) and serves the write/query HTTP
    surface.  With a ``recover_dir`` a restart restores the checkpoint,
    replays the WAL tail and skips the preload — restart *is*
    recovery.  The writer is the plane's only process on the device: it
    makes its device current before the service is built."""
    import torch

    from ..serve.protocol import make_server
    from ..serve.ranking import RankingPolicy
    from ..serve.service import TriclusterService
    from .tricluster import load_dataset

    device = torch.device(cfg["device"])
    if device.type == "cuda":
        torch.cuda.set_device(0 if device.index is None else device.index)
    inj = _child_injector(cfg, "writer")
    obs = _make_obs(cfg.get("metrics", False),
                    cfg.get("slow_query_ms", 100.0),
                    f"shard-{cfg['shard']}")
    if obs is not None:
        from ..kernels import ops

        def _launches():
            # this process's kernel launches since it started: the
            # plane's device work, read where it runs
            for name, n in ops.launch_counts().items():
                yield "kernel_launches", {"kernel": name}, n
        obs.metrics.register_collector(_launches)
    ctx = load_dataset(cfg["dataset"], cfg["n_tuples"], cfg["seed"])
    publisher = None
    if cfg["shm_prefix"]:
        from ..serve.shm import ShmPublisher
        publisher = ShmPublisher(cfg["shm_prefix"], fault=inj)
    svc = TriclusterService(
        ctx.sizes, backend=cfg["backend"], theta=cfg["theta"],
        delta=cfg["delta"], rho_min=cfg["rho_min"], minsup=cfg["minsup"],
        refresh_interval=cfg["refresh_interval"],
        dirty_threshold=cfg["dirty_threshold"],
        policy=RankingPolicy(*cfg["policy"]),
        delta_index=cfg["delta_index"], publisher=publisher,
        seed=cfg["seed"] or 0x5EED,
        recover_dir=cfg.get("recover_dir") or None,
        checkpoint_every=cfg.get("checkpoint_every", 64),
        scrub_interval=cfg.get("scrub_interval", 0.5),
        event_dir=cfg.get("flag_dir") or None,
        event_name=f"shard-{cfg['shard']}",
        version_base=(0 if publisher is None
                      else publisher.resumed_version),
        fault=inj, obs=obs, device=cfg["device"])
    if svc.recovered:
        print(f"[shard-{cfg['shard']}] recovered {svc.recovered}",
              flush=True)
    else:
        tuples, values = ctx.tuples, ctx.values
        if cfg["n_shards"] > 1:
            # deterministic load (same dataset+seed in every writer), so
            # each writer can compute ownership locally — no coordinator
            from ..core import keys as K
            from ..core import runs as RS
            plan = K.plan_mode_key(ctx.sizes, 0, with_values=False)
            own = RS.shard_of_rows(tuples, plan,
                                   cfg["n_shards"]) == cfg["shard"]
            tuples = tuples[own]
            values = None if values is None else values[own]
        n = tuples.shape[0]
        step = -(-max(n, 1) // max(1, cfg["preload_chunks"]))
        for lo in range(0, n, step):
            svc.add(tuples[lo:lo + step],
                    None if values is None or cfg["delta"] is None
                    else values[lo:lo + step])
    svc.start()
    server = _bind_server(
        lambda p: make_server(
            svc, host=cfg["host"], port=p, verbose=cfg["verbose"],
            health_max_staleness=cfg.get("health_max_staleness"),
            max_write_backlog=cfg.get("max_write_backlog", 0),
            fault=inj, obs=obs),
        _stable_port(cfg))
    flag = {"unlink": True}
    _install_sigterm(server, flag)
    with open(cfg["port_file"], "w") as f:
        f.write(str(server.port))
    print(f"[shard-{cfg['shard']}] version={svc.version} "
          f"clusters={svc.stats()['clusters']} device={svc.device} "
          f"port={server.port} pid={os.getpid()}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.drain_inflight(timeout=cfg.get("drain_timeout", 5.0))
        server.server_close()
        try:
            svc.final_checkpoint()
        except Exception:                    # noqa: BLE001 — teardown
            pass
        svc.stop()
        if publisher is not None:
            # SIGTERM (supervisor restart): keep segments so the
            # successor adopts the epoch; /shutdown: full unlink
            publisher.close(unlink=flag["unlink"])


def _child_replica(cfg: dict) -> None:
    """Spawn target: one zero-copy replica reader — attaches the
    shard's shared-memory snapshot bundles (never touches the device,
    never mines) and serves the read-only HTTP surface.  When the stuck-odd
    seqlock protocol declares the shard's writer dead, drops a restart
    flag for the supervisor."""
    from ..serve.protocol import make_server
    from ..serve.shm import ReplicaService

    inj = _child_injector(cfg, "replica")
    obs = _make_obs(cfg.get("metrics", False),
                    cfg.get("slow_query_ms", 100.0),
                    f"replica-{cfg['shard']}.{cfg['replica']}")
    on_dead = None
    if cfg.get("flag_dir"):
        from ..serve.supervise import write_restart_flag

        def on_dead(err, _cfg=cfg):
            write_restart_flag(_cfg["flag_dir"],
                               f"shard-{_cfg['shard']}")
    svc = ReplicaService(cfg["shm_prefix"],
                         connect_timeout=cfg["timeout"],
                         seqlock_spin_s=cfg.get("seqlock_spin_s", 1.0),
                         scrub_interval=cfg.get("scrub_interval", 0.5),
                         on_writer_dead=on_dead)
    svc.start(first_snapshot_timeout=cfg["timeout"])
    server = _bind_server(
        lambda p: make_server(
            svc, host=cfg["host"], port=p, verbose=cfg["verbose"],
            health_max_staleness=cfg.get("health_max_staleness"),
            fault=inj, obs=obs),
        _stable_port(cfg))
    flag = {"unlink": True}
    _install_sigterm(server, flag)
    with open(cfg["port_file"], "w") as f:
        f.write(str(server.port))
    print(f"[replica-{cfg['shard']}.{cfg['replica']}] attached "
          f"version={svc.version} port={server.port} pid={os.getpid()}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.drain_inflight(timeout=cfg.get("drain_timeout", 5.0))
        server.server_close()
        svc.stop()


def _serve_topology(args) -> int:
    """Boot ``--shards`` writer processes (+ ``--replicas`` zero-copy
    readers each) under a :class:`serve.supervise.Supervisor` and front
    them with a router endpoint.  A crashed child is restarted with
    backoff; writers recover their stream from checkpoint+WAL; replicas
    that detect a dead writer (stuck-odd seqlock) flag it for restart."""
    import multiprocessing as mp

    from ..serve.router import RouterService, Shard, make_router_server
    from ..serve.supervise import Supervisor

    mp_ctx = mp.get_context("spawn")          # fork after CUDA is unsafe
    tmp = tempfile.mkdtemp(prefix="cluster-serve-")
    recover_base = args.recover_dir or os.path.join(tmp, "recover")
    plan_json = ""
    if args.fault_plan:
        plan_json = _load_fault_plan(args.fault_plan).to_json()
    base_cfg = {
        "dataset": args.dataset, "n_tuples": args.n_tuples,
        "seed": args.seed, "backend": args.backend, "theta": args.theta,
        "delta": args.delta, "rho_min": args.rho_min,
        "minsup": args.minsup,
        "refresh_interval": args.refresh_interval,
        "dirty_threshold": args.dirty_threshold,
        "policy": (args.w_density, args.w_volume, args.w_recency),
        "delta_index": not args.no_delta_index,
        "preload_chunks": args.preload_chunks, "host": args.host,
        "verbose": args.verbose, "n_shards": args.shards,
        "timeout": args.timeout, "fault_plan": plan_json,
        "checkpoint_every": args.checkpoint_every,
        "health_max_staleness": args.health_max_staleness or None,
        "drain_timeout": args.drain_timeout,
        "max_write_backlog": args.max_write_backlog,
        "scrub_interval": args.scrub_interval,
        "flag_dir": "" if args.no_supervise else tmp,
        "metrics": args.metrics, "slow_query_ms": args.slow_query_ms,
        "device": args.device,
    }
    sup = Supervisor(flag_dir=tmp,
                     restart_backoff=args.restart_backoff,
                     max_restarts=args.max_restarts)
    shard_specs = []
    try:
        for s in range(args.shards):
            prefix = (f"cs{os.getpid()}s{s}" if args.replicas else "")
            wcfg = dict(base_cfg, shard=s, shm_prefix=prefix,
                        recover_dir=os.path.join(recover_base, f"s{s}"),
                        port_file=os.path.join(tmp, f"w{s}.port"))
            os.makedirs(wcfg["recover_dir"], exist_ok=True)
            sup.add(f"shard-{s}", _factory(mp_ctx, _child_writer, wcfg,
                                           f"shard-{s}"))
            rfiles = []
            for r in range(args.replicas):
                rcfg = dict(base_cfg, shard=s, replica=r,
                            shm_prefix=prefix,
                            port_file=os.path.join(tmp,
                                                   f"r{s}.{r}.port"))
                sup.add(f"replica-{s}.{r}",
                        _factory(mp_ctx, _child_replica, rcfg,
                                 f"replica-{s}.{r}"))
                rfiles.append(rcfg["port_file"])
            shard_specs.append((wcfg["port_file"], rfiles))
        if not args.no_supervise:
            sup.start()

        shards = []
        for wf, rfiles in shard_specs:
            wp = _wait_port_file(wf, args.timeout)
            rps = [_wait_port_file(rf, args.timeout) for rf in rfiles]
            shards.append(Shard(
                f"http://{args.host}:{wp}",
                [f"http://{args.host}:{rp}" for rp in rps]))
        router = RouterService(
            shards, timeout=args.router_timeout,
            obs=_make_obs(args.metrics, args.slow_query_ms, "router"))
        if router.obs.enabled:
            # supervisor counters fold into the same registry the
            # router scrapes — restarts and crash-loop state are part
            # of the plane's one /metrics source of truth (DESIGN.md
            # §11); scrape-time collector, so /stats keeps its shape
            def _sup_collect():
                yield ("supervisor_events_dropped", {},
                       sup.events_dropped)
                for name, ch in sup.stats()["children"].items():
                    lbl = {"child": name}
                    yield "supervisor_child_restarts", lbl, \
                        ch["restarts"]
                    yield "supervisor_child_alive", lbl, ch["alive"]
                    yield ("supervisor_child_failed", lbl,
                           ch["state"] == "failed")
            router.obs.metrics.register_collector(_sup_collect)
        server = make_router_server(
            router, host=args.host, port=args.port,
            allow_shutdown=not args.no_shutdown,
            cascade_shutdown=True, verbose=args.verbose)
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(server.port))
        h = router.health()
        print(f"[cluster-serve] router over {args.shards} shard(s) x "
              f"{args.replicas} replica(s): clusters={h['clusters']} "
              f"shard_versions={h['shard_versions']} "
              f"supervised={not args.no_supervise}", flush=True)
        print(f"[cluster-serve] listening on "
              f"http://{args.host}:{server.port}", flush=True)
        _install_sigterm(server, {"unlink": False})
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
            router.shutdown_backends()
            # let the children drain to clean exits before the
            # supervisor terminates anything: SIGTERM mid-drain flips a
            # writer to keep-segments mode (supervisor-restart
            # semantics) and would leak its shm namespace on what is a
            # full plane shutdown
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and any(
                    c["alive"] for c in
                    sup.stats()["children"].values()):
                time.sleep(0.1)
            router.close()
    finally:
        sup.stop(terminate=True)
        print("[cluster-serve] stopped "
              f"(supervisor: {sup.stats()['children']})", flush=True)
    return 0


def _factory(mp_ctx, target, cfg: dict, name: str):
    """The supervisor's factory of child ``name``.  An injected fault is
    armed in the child's first boot only, as ``benchmarks/chaos.py``
    arms its plans: a restarted victim would otherwise die again at its
    first write past the same counter and crash-loop."""
    boots = [0]

    def make():
        c = dict(cfg, fault_plan=cfg["fault_plan"] if not boots[0] else "")
        boots[0] += 1
        p = mp_ctx.Process(target=target, args=(c,), daemon=True, name=name)
        p.start()
        return p
    return make


def _smoke_client(args) -> int:
    from ..serve.protocol import ClusterClient

    port = args.port
    if args.port_file:
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            try:
                with open(args.port_file) as f:
                    port = int(f.read().strip())
                break
            except (OSError, ValueError):
                time.sleep(0.1)
        else:
            print(f"[serve-smoke] no port in {args.port_file}")
            return 1
    cl = ClusterClient(f"http://{args.host}:{port}")
    h = cl.wait_ready(timeout=args.timeout)
    print(f"[serve-smoke] ready: {h}")
    sizes = cl.stats()["sizes"]

    scalar = cl.query(entity=0, mode=0, k=3)
    assert "hits" in scalar and isinstance(scalar["hits"], list), scalar
    print(f"[serve-smoke] scalar query: {len(scalar['hits'])} hit(s)")

    ents = list(range(min(64, sizes[0])))
    batch = cl.query_batch(ents, mode=0, k=3)
    assert len(batch["hits"]) == len(ents), "batch arity mismatch"
    # batch row 0 must equal the scalar query on the same snapshot
    # (per-shard versions, when the backend is a router)
    if batch.get("shard_versions", batch["version"]) \
            == scalar.get("shard_versions", scalar["version"]):
        assert batch["hits"][0] == scalar["hits"], \
            "batch/scalar hit mismatch"
    print(f"[serve-smoke] batch query over {len(ents)} entities OK")

    top = cl.query(k=3, include_components=True)
    assert top["hits"], "empty top-k on a preloaded dataset"
    scores = [hit["score"] for hit in top["hits"]]
    assert scores == sorted(scores, reverse=True), "top-k not ranked"
    sig = top["hits"][0]["signature"]
    by_sig = cl.query(signature=sig, include_components=True)
    assert by_sig["hits"] and by_sig["hits"][0]["components"] \
        == top["hits"][0]["components"], "signature round-trip mismatch"
    print(f"[serve-smoke] top-k + signature round-trip OK "
          f"(top score {scores[0]:.3f})")

    health = cl.health()
    v0 = health["version"]
    if health.get("role") == "router":
        # one write per shard (spread across the key range), then a
        # read pinned to the per-shard write token: cross-shard
        # read-your-writes through the router
        n_shards = health["shards"]
        rows = [[int(sizes[0] * (2 * s + 1) // (2 * n_shards))]
                + [0] * (len(sizes) - 1) for s in range(n_shards)]
        up = cl.upsert(rows)
        assert sum(up["stream_versions"]) > 0, up
        ref = cl.refresh()
        tok = ref["shard_versions"]
        assert len(tok) == n_shards and ref["version"] > v0, (v0, ref)
        fresh = cl.query(entity=0, at_least_version=tok, timeout=30)
        assert all(v >= t for v, t in
                   zip(fresh["shard_versions"], tok)), (fresh, tok)
        h = cl.health()
        assert h["dirty"] == 0 and h["staleness_s"] is not None, h
        print(f"[serve-smoke] router: {n_shards} shard(s), replicas="
              f"{h['replicas']}; cross-shard read-your-writes OK "
              f"(token {tok} -> {fresh['shard_versions']})")
    else:
        up = cl.upsert([[0] * len(sizes)])
        assert up["stream_version"] > 0
        ref = cl.refresh()
        assert ref["version"] > v0, \
            f"version did not advance over upsert+refresh ({v0} -> {ref})"
        fresh = cl.query(entity=0, at_least_version=ref["version"],
                         timeout=30)
        assert fresh["version"] >= ref["version"]
    print(f"[serve-smoke] upsert advanced version {v0} -> "
          f"{ref['version']}; at_least_version read OK")

    cl.shutdown()
    print("[serve-smoke] PASS")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="imdb",
                    choices=["k1", "k2", "k3", "imdb", "movielens",
                             "bibsonomy", "frames", "random"])
    ap.add_argument("--n-tuples", type=int, default=0)
    ap.add_argument("--backend", default="streaming",
                    choices=["streaming", "distributed"])
    ap.add_argument("--theta", type=float, default=0.0)
    ap.add_argument("--delta", type=float, default=None,
                    help="NOAC δ — serve the many-valued variant")
    ap.add_argument("--rho-min", type=float, default=0.0)
    ap.add_argument("--minsup", type=int, default=0)
    ap.add_argument("--refresh-interval", type=float, default=0.25,
                    help="re-mine cadence (s) once a write is pending")
    ap.add_argument("--dirty-threshold", type=int, default=64,
                    help="re-mine as soon as this many writes accumulate")
    ap.add_argument("--w-density", type=float, default=1.0)
    ap.add_argument("--w-volume", type=float, default=0.0)
    ap.add_argument("--w-recency", type=float, default=0.0)
    ap.add_argument("--preload-chunks", type=int, default=4)
    ap.add_argument("--shards", type=int, default=1,
                    help=">1: spawn per-shard writer processes behind "
                         "a serve.router endpoint")
    ap.add_argument("--replicas", type=int, default=0,
                    help="zero-copy shared-memory replica readers per "
                         "shard (implies a router topology)")
    ap.add_argument("--no-delta-index", action="store_true",
                    help="full ClusterIndex rebuild every swap "
                         "(baseline; default is delta maintenance)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787,
                    help="0 = ephemeral (use --port-file to discover)")
    ap.add_argument("--port-file", default="",
                    help="write the bound port here once listening")
    ap.add_argument("--no-shutdown", action="store_true",
                    help="disable the POST /shutdown endpoint")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-plan", default="",
                    help="serve.faults.FaultPlan JSON (inline, or a "
                         "path / @path) injected into the plane's "
                         "components — the chaos harness")
    ap.add_argument("--recover-dir", default="",
                    help="checkpoint+WAL directory (topology mode: one "
                         "subdir per shard; default: a run-scoped tmp "
                         "dir, so supervisor restarts recover)")
    ap.add_argument("--checkpoint-every", type=int, default=64,
                    help="persist a RunStore checkpoint each N writes")
    ap.add_argument("--max-write-backlog", type=int, default=0,
                    help=">0: answer 429 + Retry-After on writes once "
                         "this many are pending a re-mine (0 = off)")
    ap.add_argument("--scrub-interval", type=float, default=0.5,
                    help="background integrity-scrub cadence (s); "
                         "0 disables the scrubber thread")
    ap.add_argument("--health-max-staleness", type=float, default=0.0,
                    help=">0: /health answers 503 once the snapshot is "
                         "older than this with writes outstanding")
    ap.add_argument("--drain-timeout", type=float, default=5.0,
                    help="graceful-shutdown in-flight drain bound (s)")
    ap.add_argument("--no-supervise", action="store_true",
                    help="topology mode: no supervisor restarts")
    ap.add_argument("--restart-backoff", type=float, default=0.2,
                    help="supervisor restart backoff base (s)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="crash-loop bound per restart window")
    ap.add_argument("--router-timeout", type=float, default=15.0,
                    help="router per-request deadline budget (s) — "
                         "shard retries + degradation live under this")
    ap.add_argument("--metrics", action="store_true",
                    help="enable the observability plane: /metrics "
                         "(Prometheus text), /debug/trace (cross-"
                         "process spans) and /debug/slow on every "
                         "endpoint of the plane")
    ap.add_argument("--slow-query-ms", type=float, default=100.0,
                    help="slow-query log threshold (ms); requests at "
                         "or above it are kept in /debug/slow "
                         "(needs --metrics; negative disables the log)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the writers mine on (default cuda; "
                         "cpu runs the kernels' plain versions); replicas "
                         "and the router take none")
    ap.add_argument("--smoke-client", action="store_true",
                    help="run the CI smoke sequence against a running "
                         "server and exit (needs --port or --port-file)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="smoke client readiness timeout (s)")
    args = ap.parse_args(argv)
    if args.smoke_client:
        return _smoke_client(args)
    from ..device import resolve_device
    args.device = str(resolve_device(args.device))
    if args.shards > 1 or args.replicas > 0:
        return _serve_topology(args)
    return _serve(args)


if __name__ == "__main__":
    sys.exit(main())
