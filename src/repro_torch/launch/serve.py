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
the card (their plain versions with ``--device cpu``).  ``--model-shards`` above 1 (a
device mesh) is not ported yet.
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
    from ..device import resolve_device
    from ..models.api import get_model
    from ..models.lm import not_ported
    from ..serve.engine import ServeEngine

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        print("[serve] enc-dec serving demo uses the audio example; "
              "use examples/translate_stream.py")
        return 0
    if args.model_shards > 1:
        raise not_ported(f"--model-shards {args.model_shards} (a device "
                         "mesh)", "A13c")
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if args.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=True)
    dev = resolve_device(args.device)
    model = get_model(cfg)
    params = model.init(cfg, torch.Generator(device=dev)
                        .manual_seed(args.seed), device=dev)
    engine = ServeEngine(cfg, params, max_len=args.max_len,
                         temperature=args.temperature, seed=args.seed)
    pipeline = TokenPipeline(cfg, args.batch, args.prompt_len,
                             seed=args.seed)
    prompts = pipeline.prompts(args.batch, args.prompt_len)
    res = engine.generate(prompts, max_new_tokens=args.new_tokens)
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prompt_len≈{args.prompt_len} new={args.new_tokens} "
          f"(attention {cfg.attn_impl}, use_pallas {cfg.use_pallas}, on "
          f"{dev})")
    print(f"[serve] prefill {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.decode_s * 1e3:.1f} ms over {res.steps} steps "
          f"({res.tokens_per_s:.1f} tok/s)")
    for i, toks in enumerate(res.tokens[:2]):
        print(f"[serve] sample[{i}]: {toks[:16]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
