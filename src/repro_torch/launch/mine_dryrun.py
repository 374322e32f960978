"""Dry run of the paper's own pipeline on the production mesh: the port's
twin of ``repro.launch.mine_dryrun``.  Trace one rank of the
``DistributedMiner`` (both merge strategies) for a MovieLens-1M-scale
tuple table on the (16, 16) and (2, 16, 16) meshes
(``DistributedMiner.lowered``: the ``meta`` device, collectives recorded,
the mining kernels' meta functions where the card launches them), and
report the same roofline terms as the LM cells against the H100.

    python -m repro_torch.launch.mine_dryrun --mesh single
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..analysis.roofline import H100
from ..core.distributed import DistributedMiner
from .mesh import make_production_mesh


def run_cell(mesh, mesh_label, strategy: str, n_tuples: int, arity: int,
             sizes, axes) -> dict:
    miner = DistributedMiner(sizes, mesh, axes=axes, strategy=strategy)
    tuples = np.zeros((pad_len(n_tuples, miner.n_shards), arity), np.int32)
    t0 = time.time()
    art = miner.lowered(tuples)
    dt = time.time() - t0
    prof = art.profile
    out = {
        "cell": f"tricluster/{strategy}", "mesh": mesh_label,
        "status": "ok", "axes": list(axes), "n_shards": miner.n_shards,
        "tuples": int(tuples.shape[0]), "arity": arity,
        "trace_s": round(dt, 2),
        "flops_per_device": prof.flops,
        "tensor_flops_per_device": prof.tensor_flops,
        "bytes_per_device": prof.traffic_bytes,
        "coll_operand_bytes": prof.operand_bytes,
        "coll_wire_bytes": prof.wire_bytes,
        "by_kind": {k: list(v) for k, v in prof.by_kind.items()},
        "kernels": {k: list(v) for k, v in prof.kernels.items()},
        "argument_bytes": int(art.argument_bytes),
        "temp_bytes": int(art.temp_bytes),
        "peak_bytes": int(art.peak_bytes),
    }
    out["compute_s"] = prof.flops / H100.peak_flops
    out["memory_s"] = prof.traffic_bytes / H100.hbm_bw
    out["collective_s"] = prof.operand_bytes / H100.link_bw
    terms = {"compute": out["compute_s"], "memory": out["memory_s"],
             "collective": out["collective_s"]}
    out["bound"] = max(terms, key=terms.get)
    out["step_s"] = max(terms.values())
    return out


def pad_len(n: int, shards: int) -> int:
    return -(-n // shards) * shards


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-tuples", type=int, default=1_000_000)
    ap.add_argument("--arity", type=int, default=4)
    ap.add_argument("--out", default="results/mine_dryrun_torch.jsonl")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    args = ap.parse_args(argv)
    sizes = (6040, 3952, 5, 2048)[: args.arity]   # MovieLens-1M modes

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("1pod", make_production_mesh(multi_pod=False),
                       ("data",)))
        meshes.append(("1pod-full", make_production_mesh(multi_pod=False),
                       ("data", "model")))
    if args.mesh in ("multi", "both"):
        meshes.append(("2pod-full", make_production_mesh(multi_pod=True),
                       ("pod", "data", "model")))
    n_err = 0
    with open(args.out, "a") as f:
        for label, mesh, axes in meshes:
            for strategy in ("replicate", "shuffle"):
                print(f"[mine-dryrun] {strategy} × {label} "
                      f"(axes={axes})", flush=True)
                try:
                    row = run_cell(mesh, label, strategy, args.n_tuples,
                                   args.arity, sizes, axes)
                    print(f"  c={row['compute_s']:.4f}s "
                          f"m={row['memory_s']:.4f}s "
                          f"x={row['collective_s']:.4f}s "
                          f"-> {row['bound']} kernels "
                          f"{ {k: v[0] for k, v in row['kernels'].items()} }",
                          flush=True)
                except Exception as e:
                    n_err += 1
                    row = {"cell": f"tricluster/{strategy}", "mesh": label,
                           "status": "error", "error": str(e)[:500]}
                    print(f"  ERROR {e}", flush=True)
                f.write(json.dumps(row) + "\n")
                f.flush()
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
