"""How well float32 computes granite-moe-3b-a800m's (or another arch's)
training gradients at full width, on the CPU: the numbers behind the
tolerances of ``chip_smoke.py`` phases 14b, 16c and 17c.

    PYTHONPATH=src python scripts/torch_train_conditioning.py
        [--arch granite-moe-3b-a800m] [--depths 1,2,4,8]
        [--gate-layers 2] [--seq 512]

(xlstm-125m's 17c gate: ``--arch xlstm-125m --depths 4,12 --gate-layers
4 --seq 256``; ``--gate-layers 8`` and ``12`` show why it is cut.
seamless-m4t-large-v2's 18c gate: ``--arch seamless-m4t-large-v2
--depths 1,2 --gate-layers 1 --seq 256 --device cuda``, a depth being n
encoder and n decoder layers and the batch's frames as long as its
tokens.)

1. The global gradient norm of ``lm.loss_fn`` at full width by depth (1,
   2, 4, 8 layers; 1 x 128 tokens; float32): the parameter init (the JAX
   package's: N(0, 1) times 1/sqrt(shape[-2]), so ``wq`` (d, h, hd) gets
   1/sqrt(h)) makes attention logits and gradients grow with depth.
2. At the gate's size (``--gate-layers`` layers, 1 x ``--seq`` tokens;
   14b's: 2 layers, 1 x 512 tokens): the loss, the global
   gradient norm and every leaf's gradient in float32 against the same
   computation in float64, as relative errors (a leaf's: max |error| over
   the leaf's max |gradient|).  Two correct float32 runs (the card's and
   the CPU's) can each be that far from float64.

The float64 run is the model's ``dtype="float64"`` (the port's float64
evaluation); the port trains in bfloat16 or float32.  About a minute on 8
cores; ``--device cuda`` runs it on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import (ParamTree, tree_items,  # noqa: E402
                                       tree_map)


def grads(cfg, params, batch, dtype):
    cfg = dataclasses.replace(cfg, dtype=str(dtype).removeprefix("torch."))
    loss, _ = get_model(cfg).loss(cfg, params, batch)
    items = tree_items(params)
    g = torch.autograd.grad(loss, [p for _, p in items])
    return float(loss.detach()), {path: x for (path, _), x in zip(items, g)}


def norm(g: dict) -> float:
    return float(sum((x.double() ** 2).sum() for x in g.values()) ** 0.5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--depths", default="1,2,4,8")
    ap.add_argument("--gate-layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(get_config(args.arch), dtype="float32")
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU")
    print(f"{base.name} at full width (d {base.d_model}, {base.n_experts} "
          f"experts top-{base.top_k}, vocab {base.vocab_size}), float32, "
          f"on {where}")

    def cut(n):
        return dataclasses.replace(base, n_layers=n, **(
            {"enc_layers": n} if base.family == "encdec" else {}))

    def batch_of(cfg, seq):
        return {k: torch.from_numpy(v).to(dev) for k, v in
                TokenPipeline(cfg, 1, seq, seed=0).batch_at(0).items()}

    for n in (int(x) for x in args.depths.split(",")):
        cfg = cut(n)
        p = get_model(cfg).init(cfg, torch.Generator(device=dev)
                                .manual_seed(0), device=dev,
                                requires_grad=True)
        loss, g = grads(cfg, p, batch_of(cfg, 128), torch.float32)
        print(f"depth {n}: loss {loss:.6f}, global grad norm {norm(g):.6e}",
              flush=True)
        del p, g

    n = args.gate_layers
    cfg = cut(n)
    p32 = get_model(cfg).init(cfg, torch.Generator(device=dev)
                              .manual_seed(0), device=dev,
                              requires_grad=True)
    p64 = ParamTree.from_tensors(tree_map(lambda t: t.detach().double(),
                                          p32), requires_grad=True)
    batch = batch_of(cfg, args.seq)
    l32, g32 = grads(cfg, p32, batch, torch.float32)
    l64, g64 = grads(cfg, p64, batch, torch.float64)
    print(f"{n} layers, 1 x {args.seq} tokens, float32 against float64: loss "
          f"{l32:.6f} / {l64:.6f} (relative error {abs(l32 / l64 - 1):.3e}),"
          f" global grad norm {norm(g32):.6f} / {norm(g64):.6f} (relative "
          f"error {abs(norm(g32) / norm(g64) - 1):.3e})")
    worst = 0.0
    for path, a in g32.items():
        b = g64[path]
        e = float((a.double() - b).abs().max() / b.abs().max())
        worst = max(worst, e)
        print(f"  {'/'.join(path)}: max |error| {e:.3e} of the leaf's max "
              f"|gradient|")
    print(f"worst leaf: {worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
