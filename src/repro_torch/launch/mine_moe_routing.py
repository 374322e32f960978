"""Mine triclusters of MoE routing decisions on the PyTorch port
(DESIGN.md §5):

    python -m repro_torch.launch.mine_moe_routing [--arch mixtral-8x7b]
        [--device cuda|cpu] [--attn-impl einsum|blocked|pallas]

The twin of ``examples/mine_moe_routing.py``: runs a reduced-config MoE
forward over the synthetic motif corpus, collects the (token × expert ×
layer) Boolean routing tensor, and mines OAC triclusters from it with
``core.BatchMiner``: each pattern is a token group that the router sends
to the same expert group across a layer group.  The weights are drawn
from a seeded ``torch.Generator``, so they are not the JAX example's.
``--attn-impl pallas`` runs the flash-attention kernel on the card (its
plain version with ``--device cpu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b",
                    choices=["mixtral-8x7b", "granite-moe-3b-a800m"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--theta", type=float, default=0.2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--attn-impl", default=None,
                    choices=["einsum", "blocked", "pallas"],
                    help="attention implementation (default: the config's)")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_smoke_config
    from ..core import BatchMiner
    from ..data.tokens import TokenPipeline
    from ..device import resolve_device
    from ..models.api import get_model
    from ..models.telemetry import collect_moe_routing, routing_context

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = get_model(cfg).init(cfg, gen, device=dev)
    pipeline = TokenPipeline(cfg, args.batch, args.seq, seed=0)
    tokens = pipeline.batch_at(0)["tokens"]

    routes = collect_moe_routing(cfg, params, tokens)
    ctx = routing_context(cfg, tokens, routes)
    print(f"routing context: vocab={ctx.sizes[0]} experts={ctx.sizes[1]} "
          f"layers={ctx.sizes[2]}, |I|={ctx.num_tuples} "
          f"(density {ctx.density:.4f}; attention {cfg.attn_impl} on "
          f"{dev})")

    miner = BatchMiner(ctx.sizes, theta=args.theta, device=dev)
    res = miner(ctx.tuples)
    n = int(res.is_unique.sum())
    kept = int(res.keep.sum())
    print(f"{n} routing triclusters, {kept} with density >= {args.theta}")

    clusters = miner.materialise(res, ctx.tuples, only_kept=False)
    # rank by support (density × volume); show expert/layer groups compactly
    clusters.sort(key=lambda cd: -cd[1] * float(np.prod(
        [len(c) for c in cd[0]])))
    print("\ntop co-activation patterns (tokens | experts | layers):")
    for comps, dens in clusters[:4]:
        toks, experts, layers = comps
        tk = sorted(toks)
        tks = (f"{len(tk)} tokens e.g. {tk[:6]}" if len(tk) > 6
               else str(tk))
        print(f"  {tks} | experts {sorted(experts)} | layers "
              f"{sorted(layers)} | ρ̂={dens:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
