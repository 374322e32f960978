"""The paper's application driver on the PyTorch port:
``python -m repro_torch.launch.tricluster --dataset imdb --backend batch``.

The twin of ``repro.launch.tricluster`` for the engines the port has
(``batch`` on one device, with the out-of-core ``--chunk-budget`` and
``--window-budget`` paths; ``distributed``, the ranks of a process group
with the ``--strategy`` merge, one-shot or ``--incremental``;
``streaming``, incremental sorted-run snapshots over ``--chunks``
ingestion chunks; and ``reference``, the pure-python oracle — each in the
prime and NOAC variants), with the flags that apply to them and
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain versions;
the reference backend runs on the host either way).  Prints timings,
cluster counts, and §5.2-formatted top patterns
(``core.postprocess.format_cluster``).  An unknown backend/variant
returns 2 with the valid combinations on stderr.  ``--top-k`` and
``--query-*`` wait for the serving layer (ROADMAP A10).

Under ``torchrun`` (``WORLD_SIZE`` set) every rank joins the default
process group — NCCL on the card (one rank a card, ``cuda:LOCAL_RANK``),
gloo with ``--device cpu`` — and only rank 0 prints::

    torchrun --nproc-per-node 2 -m repro_torch.launch.tricluster \
        --backend distributed --strategy shuffle --device cpu

Without it the distributed backend runs one rank.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys


def load_dataset(name: str, n_tuples: int, seed: int):
    from ..data import synthetic as S
    if name == "k1":
        return S.k1_dense_cube()
    if name == "k2":
        return S.k2_three_cuboids()
    if name == "k3":
        return S.k3_dense_4d()
    if name == "imdb":
        return S.imdb_like(seed=seed)
    if name == "movielens":
        return S.movielens_like(n_tuples=n_tuples or 100_000, seed=seed)
    if name == "bibsonomy":
        return S.bibsonomy_like(n_tuples=n_tuples or 816_197, seed=seed)
    if name == "frames":
        return S.semantic_frames_like(n_tuples=n_tuples or 100_000,
                                      seed=seed)
    if name == "random":
        return S.random_context((64, 48, 32), n_tuples or 4096, seed=seed)
    raise ValueError(f"unknown dataset {name!r}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="imdb",
                    choices=["k1", "k2", "k3", "imdb", "movielens",
                             "bibsonomy", "frames", "random"])
    ap.add_argument("--n-tuples", type=int, default=0)
    ap.add_argument("--backend", default="batch",
                    help="engine backend (see "
                         "repro_torch.core.available_engines)")
    ap.add_argument("--variant", default=None,
                    help="'prime' | 'noac'; default: noac iff --delta given")
    ap.add_argument("--strategy", default="replicate",
                    choices=["replicate", "shuffle"],
                    help="distributed: replicate the table on every rank, "
                         "or the M/R shuffle to key-owner ranks")
    ap.add_argument("--theta", type=float, default=0.0,
                    help="min density (Alg. 7 estimate)")
    ap.add_argument("--delta", type=float, default=None,
                    help="NOAC δ for many-valued contexts")
    ap.add_argument("--rho-min", type=float, default=0.0)
    ap.add_argument("--minsup", type=int, default=0)
    ap.add_argument("--chunks", type=int, default=8,
                    help="streaming / incremental-distributed: number of "
                         "ingestion chunks")
    ap.add_argument("--chunk-budget", type=int, default=0,
                    help="batch: out-of-core chunked Stage 1 — sort at "
                         "most this many rows per host chunk "
                         "(core.runs store; 0 = in-core)")
    ap.add_argument("--window-budget", type=int, default=0,
                    help="windowed device pipeline (core.windowed): "
                         "stream Stage 1-3 through sorted-order windows "
                         "of at most this many rows — peak incremental "
                         "device memory O(window), bit-identical to the "
                         "monolithic path (0 = off)")
    ap.add_argument("--incremental", action="store_true",
                    help="streaming: the sorted-run merge path (the "
                         "default); distributed: chunked ingestion into "
                         "per-shard run stores + one merged-run snapshot "
                         "instead of one-shot mining")
    ap.add_argument("--no-incremental", action="store_true",
                    help="streaming: full device re-sort per snapshot "
                         "(disable the sorted-run merge path)")
    ap.add_argument("--sort-path", default="auto",
                    choices=["auto", "packed", "lexsort"],
                    help="Stage-1/3 sort: packed single-word keys "
                         "(core.keys), the lexsort baseline, or auto "
                         "(packed whenever the key fits 64 bits)")
    ap.add_argument("--sort-backend", default="auto",
                    choices=["auto", "radix", "lax", "lexsort"],
                    help="packed word-sort algorithm: the bit-plan-"
                         "pruned LSD radix (core.radix; the auto "
                         "default for fitting keys), one stable "
                         "torch.sort, or lexsort to force the column path")
    ap.add_argument("--no-prune-values", action="store_true",
                    help="disable value-lane cardinality pruning (keep "
                         "the 32-bit float lane in many-valued keys)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to mine on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--print-top", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1,
                    help="timing repeats (paper used 5)")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        return _main(args)
    import torch
    import torch.distributed as dist
    if torch.device(args.device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    try:
        if dist.get_rank() == 0:
            return _main(args)
        with open(os.devnull, "w") as quiet, \
                contextlib.redirect_stdout(quiet):
            return _main(args)
    finally:
        dist.destroy_process_group()


def _main(args) -> int:
    from ..core import available_engines, mine
    from ..core import postprocess as PP

    variant = args.variant or ("noac" if args.delta is not None else "prime")
    ctx = load_dataset(args.dataset, args.n_tuples, args.seed)
    print(f"[tricluster] dataset={args.dataset} sizes={ctx.sizes} "
          f"|I|={ctx.tuples.shape[0]} device={args.device}")

    try:
        packed = {"auto": None, "packed": True, "lexsort": False}
        incremental = (False if args.no_incremental
                       else True if args.incremental
                       else None)
        run = mine(ctx, backend=args.backend, variant=variant,
                   theta=args.theta, delta=args.delta,
                   rho_min=args.rho_min, minsup=args.minsup,
                   strategy=args.strategy, chunks=args.chunks,
                   chunk_budget=args.chunk_budget or None,
                   window_budget=args.window_budget or None,
                   **({} if incremental is None
                      else {"incremental": incremental}),
                   packed=packed[args.sort_path],
                   sort_backend=(None if args.sort_backend == "auto"
                                 else args.sort_backend),
                   prune_values=not args.no_prune_values,
                   device=args.device, seed=args.seed or 0x5EED)
        # warm repeats reuse the engine (paper best-of-N protocol)
        best = run.elapsed_s
        for _ in range(max(1, args.repeat) - 1):
            run.rerun()
            best = min(best, run.rerun.last_s)
        run.elapsed_s = best
    except ValueError as e:
        valid = ", ".join(f"{b}/{v}" for b, v in available_engines())
        print(f"[tricluster] error: {e}", file=sys.stderr)
        print(f"[tricluster] valid backend/variant choices: {valid}",
              file=sys.stderr)
        return 2

    label = args.backend + (f"/{args.strategy}"
                            if args.backend == "distributed" else "")
    if variant == "noac":
        print(f"[tricluster] NOAC(δ={args.delta}, ρ={args.rho_min}, "
              f"minsup={args.minsup}) backend={label}: "
              f"{run.n_clusters} triclusters; "
              f"best {run.elapsed_s * 1e3:.1f} ms over {args.repeat} run(s)")
    else:
        print(f"[tricluster] backend={label} θ={args.theta}: "
              f"{run.n_clusters} unique clusters; "
              f"best {run.elapsed_s * 1e3:.1f} ms over {args.repeat} run(s)")
    overflow = getattr(run.result, "overflow", None)
    if overflow is not None:
        print(f"[tricluster] shuffle overflow flag: {int(overflow)}")

    if args.print_top and run.clusters:
        mats = sorted(run.clusters, key=lambda cd: -(cd[1]
                                                     if cd[1] == cd[1] else 0))
        names = ctx.names if getattr(ctx, "names", None) else None
        for comps, dens in mats[:args.print_top]:
            print(PP.format_cluster(comps, names=names,
                                    density=None if dens != dens else dens))
    return 0


if __name__ == "__main__":
    sys.exit(main())
