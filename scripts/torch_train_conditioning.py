"""How well float32 computes granite-moe-3b-a800m's training gradients at
full width, on the CPU: the numbers behind the tolerances of
``chip_smoke.py`` phase 14b.

    PYTHONPATH=src python scripts/torch_train_conditioning.py

1. The global gradient norm of ``lm.loss_fn`` at full width by depth (1,
   2, 4, 8 layers; 1 x 128 tokens; float32): the parameter init (the JAX
   package's: N(0, 1) times 1/sqrt(shape[-2]), so ``wq`` (d, h, hd) gets
   1/sqrt(h)) makes attention logits and gradients grow with depth.
2. At phase 14b's size (2 layers, 1 x 512 tokens): the loss, the global
   gradient norm and every leaf's gradient in float32 against the same
   computation in float64, as relative errors (a leaf's: max |error| over
   the leaf's max |gradient|).  Two correct float32 runs (the card's and
   the CPU's) can each be that far from float64.

The float64 run swaps ``models.lm.compute_dtype`` for this script only;
the port trains in bfloat16 or float32.  About a minute on 8 cores.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.models import lm as L  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.params import (ParamTree, tree_items,  # noqa: E402
                                       tree_map)


def grads(cfg, params, batch, dtype):
    real = L.compute_dtype
    L.compute_dtype = lambda c: dtype
    try:
        loss, _ = L.loss_fn(cfg, params, batch)
        items = tree_items(params)
        g = torch.autograd.grad(loss, [p for _, p in items])
    finally:
        L.compute_dtype = real
    return float(loss.detach()), {path: x for (path, _), x in zip(items, g)}


def norm(g: dict) -> float:
    return float(sum((x.double() ** 2).sum() for x in g.values()) ** 0.5)


def main() -> int:
    base = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                               dtype="float32")
    print(f"{base.name} at full width (d {base.d_model}, {base.n_experts} "
          f"experts top-{base.top_k}, vocab {base.vocab_size}), float32, "
          "on the CPU")
    for n in (1, 2, 4, 8):
        cfg = dataclasses.replace(base, n_layers=n)
        p = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                                device="cpu", requires_grad=True)
        loss, g = grads(cfg, p, TokenPipeline(cfg, 1, 128, seed=0)
                        .batch_at(0), torch.float32)
        print(f"depth {n}: loss {loss:.6f}, global grad norm {norm(g):.6e}",
              flush=True)

    cfg = dataclasses.replace(base, n_layers=2)
    p32 = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                              device="cpu", requires_grad=True)
    p64 = ParamTree.from_tensors(tree_map(lambda t: t.detach().double(),
                                          p32), requires_grad=True)
    batch = TokenPipeline(cfg, 1, 512, seed=0).batch_at(0)
    l32, g32 = grads(cfg, p32, batch, torch.float32)
    l64, g64 = grads(cfg, p64, batch, torch.float64)
    print(f"2 layers, 1 x 512 tokens, float32 against float64: loss "
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
