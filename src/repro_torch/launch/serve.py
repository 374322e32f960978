"""Serving entry point of the PyTorch port:

    python -m repro_torch.launch.serve --arch <id> [--smoke]
        [--device cuda|cpu] [--attn-impl einsum|blocked|pallas]
        [--use-pallas]

The twin of ``repro.launch.serve``: batched prefill + ragged decode over
the ``ServeEngine``; prints prefill latency, decode throughput, and a
sample of generated ids.  The weights are drawn from a seeded
``torch.Generator``, so they are not the JAX entry point's.  ``--attn-impl
pallas`` decodes through the ``decode_attention`` kernel and
``--use-pallas`` sends every RMSNorm through the ``rmsnorm`` kernel, on
the card (their plain versions with ``--device cpu``).

As the JAX launcher, it always serves over a ``(data, model)`` mesh of
the ranks there are, ``--model-shards`` of them on ``model``
(``sharding.MeshRules``; one rank alone makes a ``(1, 1)`` mesh, which
computes what no mesh computes, bit for bit).  Several ranks come from
``torchrun``:

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --smoke --model-shards 2 --device cpu

Each rank takes ``cuda:LOCAL_RANK`` (modulo the cards there are; NCCL
when every rank has a card of its own, else a gloo group staged through
host memory), or the CPU with ``--device cpu``; rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--attn-impl", default=None,
                    choices=["einsum", "blocked", "pallas"],
                    help="attention implementation (default: the config's)")
    ap.add_argument("--use-pallas", action="store_true",
                    help="every RMSNorm through the rmsnorm kernel "
                         "(the config's use_pallas; default: the config's)")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config, get_smoke_config
    from ..data.tokens import TokenPipeline
    from ..models.api import get_model
    from ..serve.engine import ServeEngine
    from ..sharding import MeshRules
    from .mesh import init_distributed, make_local_mesh, mesh_name

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        print("[serve] enc-dec serving demo uses the audio example; "
              "use examples/translate_stream.py")
        return 0
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=True)
    joined = not torch.distributed.is_initialized()
    dev = init_distributed(args.device)
    try:
        mesh = make_local_mesh(model=args.model_shards, device=dev)
        rules = MeshRules(mesh, fsdp=cfg.fsdp)
        model = get_model(cfg)
        params = model.init(cfg, torch.Generator(device=dev)
                            .manual_seed(args.seed), device=dev,
                            rules=rules)
        engine = ServeEngine(cfg, params, max_len=args.max_len, rules=rules,
                             temperature=args.temperature, seed=args.seed)
        pipeline = TokenPipeline(cfg, args.batch, args.prompt_len,
                                 seed=args.seed)
        prompts = pipeline.prompts(args.batch, args.prompt_len)
        res = engine.generate(prompts, max_new_tokens=args.new_tokens)
        rank, name = mesh.rank, mesh_name(mesh)
    finally:
        if joined and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if rank != 0:
        return 0
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prompt_len≈{args.prompt_len} new={args.new_tokens} "
          f"(attention {cfg.attn_impl}, use_pallas {cfg.use_pallas}, on "
          f"{dev})")
    print(f"[serve] mesh {name} (data x model)")
    print(f"[serve] prefill {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.decode_s * 1e3:.1f} ms over {res.steps} steps "
          f"({res.tokens_per_s:.1f} tok/s)")
    for i, toks in enumerate(res.tokens[:2]):
        print(f"[serve] sample[{i}]: {toks[:16]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
