"""Subprocess body: the JAX package's ``DistributedMiner`` on a forced
8-host-device mesh, (8,) and (2, 4), against 8 gloo ranks of the port
(``repro_torch.core.DistributedMiner``, spawned processes), every
gathered leaf bit for bit, and the final ``capacity_factor`` after the
overflow retries; and the per-shard incremental stores (``ingest``, a
delete, then ``snapshot``, ``snapshot(full_remine=True)`` and
``serving_snapshot``) at 8 ranks, or at 4 ranks with ``python
_torch_distributed_check.py 4``, which also mines over a sub-mesh: the
table split over ``data`` of a (2, 2) ``(data, model)`` mesh and
replicated over ``model``.  Invoked by
``test_torch_distributed.py``; prints 'OK' on success.

JAX is imported in the parent process only: the ranks are spawned (not
forked), import nothing of it, and mine while the parent computes JAX's
results; rank 0 compares once they are saved."""
import datetime
import os
import sys
import tempfile
import time

import numpy as np

RANKS = int(sys.argv[1]) if len(sys.argv) > 1 else 8

#: name -> (mesh shape, mesh axis names, data axes, strategy, miner kw).
#: The shuffle cases but one run at a capacity factor of 4, which these
#: small tables do not overflow (each retry recompiles JAX's body).
CASES = {
    "prime_replicate": ((8,), ("data",), "data", "replicate", {}),
    "prime_shuffle": ((8,), ("data",), "data", "shuffle",
                      {"theta": 0.3, "capacity_factor": 4.0}),
    "noac_shuffle_pod": ((2, 4), ("pod", "data"), ("pod", "data"),
                         "shuffle", {"delta": 80.0, "rho_min": 0.3,
                                     "minsup": 2, "capacity_factor": 4.0}),
    # capacity below a fair share: overflow, retried with doubled
    # capacity until exact
    "overflow_retry": ((8,), ("data",), "data", "shuffle",
                       {"capacity_factor": 0.5}),
    # power-law ids: one top digit holds most keys, so the range
    # partition falls back to the hash partition
    "skewed_hash_fallback": ((8,), ("data",), "data", "shuffle",
                             {"capacity_factor": 4.0}),
}

#: The 4-rank cases: a (2, 2) mesh mined over "data" alone (replicated
#: compute over "model", as a JAX ``shard_map`` whose specs leave it out).
SUBMESH_CASES = {
    "prime_shuffle_submesh": ((2, 2), ("data", "model"), "data", "shuffle",
                              {"theta": 0.3, "capacity_factor": 4.0}),
    "noac_replicate_submesh": ((2, 2), ("data", "model"), "data",
                               "replicate", {"delta": 80.0, "rho_min": 0.3,
                                             "minsup": 2}),
}

LEAVES = ("sig_lo", "sig_hi", "is_unique", "gen_count", "volume",
          "density", "keep", "cardinalities", "n_clusters", "overflow")

#: The leaves of the full-table serving snapshot (a ``PipelineResult``).
SERVING_LEAVES = ("sig_lo", "sig_hi", "is_unique", "gen_count", "volume",
                  "density", "keep", "cardinalities", "range_lo",
                  "range_hi", "sorted_e", "perms")

#: The incremental stream over a (RANKS,) mesh: the snapshots it takes.
STREAM = "incremental_stream"
SNAPSHOTS = ("snapshot", "full_remine", "serving")


def stream_snapshots(miner, S):
    """Ingest a context in 4 chunks into the per-shard stores, delete a
    few rows, and take the three snapshots — {name: result}."""
    ctx = S.random_context((9, 8, 7), 203, seed=12)
    step = -(-ctx.num_tuples // 4)
    for lo in range(0, ctx.num_tuples, step):
        miner.ingest(ctx.tuples[lo:lo + step])
    miner.delete(ctx.tuples[:6])
    return {"snapshot": miner.snapshot(),
            "full_remine": miner.snapshot(full_remine=True),
            "serving": miner.serving_snapshot()}


def context(name, S):
    """(tuples, values) of a case, from either package's generators
    (which are identical), padded to the rank count."""
    if name in ("prime_replicate", "prime_shuffle_submesh"):
        ctx = S.random_context((9, 7, 5), 160, seed=0)
    elif name == "prime_shuffle":
        ctx = S.random_context((6, 6, 6, 4), 240, seed=1)
    elif name in ("noac_shuffle_pod", "noac_replicate_submesh"):
        ctx = S.random_context((7, 6, 5), 120, seed=4,
                               values=True).deduplicated()
    elif name == "overflow_retry":
        ctx = S.random_context((9, 8, 7), 200, seed=5)
    else:
        ctx = S.bibsonomy_like(n_tuples=150_000, scale=0.002)
    pad = (-ctx.num_tuples) % RANKS
    tuples = np.concatenate([ctx.tuples, np.repeat(ctx.tuples[:1], pad, 0)])
    values = None
    if ctx.values is not None:
        values = np.concatenate([ctx.values,
                                 np.repeat(ctx.values[:1], pad)])
    return ctx.sizes, tuples, values


def cases():
    """The one-shot cases of this rank count (their meshes need 8, or 4
    for the sub-mesh cases)."""
    return CASES if RANKS == 8 else SUBMESH_CASES if RANKS == 4 else {}


def jax_results(path):
    """Every case's leaves and final capacity factor, and the stream's
    snapshots, from the JAX package, saved to ``path`` (npz)."""
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={RANKS}"
    from repro.core import DistributedMiner
    from repro.data import synthetic as JS
    from repro.launch.mesh import make_mesh
    out = {}
    snaps = stream_snapshots(
        DistributedMiner((9, 8, 7), make_mesh((RANKS,), ("data",))), JS)
    for what, res in snaps.items():
        for leaf in SERVING_LEAVES if what == "serving" else LEAVES:
            out[f"{STREAM}/{what}/{leaf}"] = np.asarray(getattr(res, leaf))
    for name, (shape, names, axes, strategy, kw) in cases().items():
        sizes, tuples, values = context(name, JS)
        miner = DistributedMiner(sizes, make_mesh(shape, names), axes=axes,
                                 strategy=strategy, **kw)
        res = miner(tuples, values)
        for leaf in LEAVES:
            out[f"{name}/{leaf}"] = np.asarray(getattr(res, leaf))
        out[f"{name}/capacity_factor"] = np.float64(miner.capacity_factor)
    np.savez(path + ".tmp.npz", **out)
    os.replace(path + ".tmp.npz", path)


def wait_for(path, timeout=600.0):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)
    return np.load(path)


def rank_main(rank, tmp):
    """One gloo rank of the port: every case, compared on rank 0."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init",
                            rank=rank, world_size=RANKS,
                            timeout=datetime.timedelta(seconds=300))
    try:
        from repro_torch.core import DistributedMiner
        from repro_torch.data import synthetic as TS
        from repro_torch.launch.mesh import make_mesh
        got = {}
        mesh = make_mesh((RANKS,), ("data",), device="cpu")
        snaps = stream_snapshots(DistributedMiner((9, 8, 7), mesh), TS)
        # gathering is a collective: every rank takes part
        snaps = {what: res if what == "serving" else res.gather()
                 for what, res in snaps.items()}
        for name, (shape, names, axes, strategy, kw) in cases().items():
            sizes, tuples, values = context(name, TS)
            mesh = make_mesh(shape, names, device="cpu")
            miner = DistributedMiner(sizes, mesh, axes=axes,
                                     strategy=strategy, **kw)
            res = miner(tuples, values).gather()
            got[name] = (res, miner.capacity_factor,
                         [bool(f) for f in miner.hash_fallback])
        if rank:
            return
        want = wait_for(f"{tmp}/jax.npz")
        for what in SNAPSHOTS:
            res = snaps[what]
            leaves = SERVING_LEAVES if what == "serving" else LEAVES
            for leaf in leaves:
                w = want[f"{STREAM}/{what}/{leaf}"]
                g = getattr(res, leaf).numpy()
                if w.dtype == np.uint32:
                    g = g.view(np.uint32)
                if g.dtype != w.dtype or not np.array_equal(g, w):
                    raise AssertionError(f"{STREAM} {what}: leaf {leaf} "
                                         f"differs ({g.dtype} vs {w.dtype})")
            print(f"{STREAM} {what} at {RANKS} ranks: {len(leaves)} "
                  "leaves equal", flush=True)
        for name, (res, factor, fallback) in got.items():
            kw = cases()[name][-1]
            for leaf in LEAVES:
                w = want[f"{name}/{leaf}"]
                g = getattr(res, leaf).numpy()
                if w.dtype == np.uint32:
                    g = g.view(np.uint32)
                if g.dtype != w.dtype or not np.array_equal(g, w):
                    raise AssertionError(f"{name}: leaf {leaf} differs "
                                         f"({g.dtype} vs {w.dtype})")
            cf = float(want[f"{name}/capacity_factor"])
            if factor != cf:
                raise AssertionError(f"{name}: capacity_factor "
                                     f"{factor} != {cf}")
            if name == "overflow_retry" and cf <= kw["capacity_factor"]:
                raise AssertionError(f"{name}: no retry ({cf})")
            if name == "skewed_hash_fallback" and not any(fallback):
                raise AssertionError(f"{name}: the range partition held")
            print(f"{name}: {len(LEAVES)} leaves equal, capacity_factor "
                  f"{cf}, hash fallback by mode {fallback}", flush=True)
    finally:
        dist.destroy_process_group()


def main():
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mp.start_processes(rank_main, args=(tmp,), nprocs=RANKS,
                                   start_method="spawn", join=False)
        try:
            jax_results(f"{tmp}/jax.npz")
            while not ranks.join():
                pass
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.terminate()
    print("OK")


if __name__ == "__main__":
    sys.exit(main())
