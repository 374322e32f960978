"""One cluster-service swap of the PyTorch port over the first N rows of
BibSonomy's table (the full context's mode sizes and generator), for
each N given: ``TriclusterService`` (streaming backend, delta index, an
``obs`` hub) ingests the rows in 8 chunks and publishes its first
snapshot (a full index build), then upserts 0.1% of the rows with a new
tag and refreshes (a delta build), then answers one batch of 4,096
any-mode entity queries (k 10).  Prints one JSON line per N: the mine
(readback included), index-build and swap ms from the hub, the readback
bytes, the clusters, the component members the index holds (the size
of its host arrays) and the query ms.

    python3 scripts/torch_service_swap.py [--device cpu] N [N ...]

The miner runs on ``--device`` (default ``cuda``; its name is printed);
the index, ranking and queries are host numpy either way.
"""
import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("rows", type=int, nargs="+")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    import numpy as np
    import torch
    from repro_torch.data import synthetic as S
    from repro_torch.obs import Obs
    from repro_torch.serve import TriclusterService
    if torch.device(args.device).type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
        print(torch.cuda.get_device_name(0), flush=True)
    bib = S.bibsonomy_like()
    for n in args.rows:
        table = bib.tuples[:n]
        rng = np.random.default_rng(2027)
        obs = Obs.create()
        svc = TriclusterService(bib.sizes, obs=obs, device=args.device,
                                refresh_interval=3600.0,
                                dirty_threshold=10**9, scrub_interval=0.0)
        step = -(-n // 8)
        for lo in range(0, n, step):
            svc.add(table[lo:lo + step])
        svc.start()
        rows = table[rng.choice(n, max(1, n // 1000), replace=False)].copy()
        rows[:, 2] = rng.integers(0, bib.sizes[2], rows.shape[0])
        svc.upsert(rows)
        snap = svc.refresh()
        ents = rng.integers(0, max(bib.sizes), 4096)
        svc.query_batch(ents, k=10)          # materialises the flat arrays
        t0 = time.perf_counter()
        svc.query_batch(ents, k=10)
        query_ms = (time.perf_counter() - t0) * 1e3
        swaps = [s["attrs"] for s in obs.tracer.spans()
                 if s["name"] == "service.swap"]
        swap = obs.metrics.histogram("service_swap_ms").snapshot()
        svc.stop()
        print(json.dumps({
            "rows": n, "device": args.device,
            "clusters": len(snap.index),
            "members": int(sum(int(b[-1]) for b in snap.index.comp_bounds)),
            "changed": svc.dirty_clusters,
            "readback_bytes": swaps[-1]["readback_bytes"],
            "readback_ms": [s["readback_ms"] for s in swaps],
            "mine_ms": [s["mine_ms"] for s in swaps],
            "index_build_ms": {s["build"]: s["index_build_ms"]
                               for s in swaps},
            "swap_ms": [swap["min"], swap["max"]],
            "query_batch_ms": query_ms}), flush=True)


if __name__ == "__main__":
    main()
