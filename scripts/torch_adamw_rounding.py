"""AdamW's parameter update, operation by operation, on the card against
the host on the same float32 inputs: the number behind the update gate of
``chip_smoke.py`` phase 14b.

    python scripts/torch_adamw_rounding.py

1. The bias corrections ``1 - b ** t`` of ``train.optim.adamw_update``
   (b1 0.9, b2 0.95, steps 1-6), computed on each device from a float32
   step, compared bit for bit.
2. The update ``p - lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd * p)`` of
   one step on 4,194,304 elements (gradients N(0, 1e-3), parameters
   N(0, 0.02), the moments of a first step): each intermediate, and each
   operation applied alone to the host's own inputs, as the count of
   elements that differ between the devices.  ``sqrt`` and the division
   are also held against float64 rounded to float32 (correctly rounded).

Needs a CUDA card; a few seconds.
"""
from __future__ import annotations

import sys

import torch

B1, B2, EPS, WD, LR = 0.9, 0.95, 1e-8, 0.1, 3e-3


def update(m, v, p, lr, bc1, bc2) -> dict:
    """The update's intermediates, in ``adamw_update``'s order."""
    out = {"m / bc1": m / bc1, "v / bc2": torch.div(v, bc2)}
    out["sqrt"] = out["v / bc2"].sqrt()
    out["+ eps"] = out["sqrt"] + EPS
    out["mh / den"] = out["m / bc1"] / out["+ eps"]
    out["wd * p"] = WD * p
    out["+ wd * p"] = out["mh / den"] + out["wd * p"]
    out["* lr"] = out["+ wd * p"] * lr
    out["p - upd"] = p - out["* lr"]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for t in range(1, 7):
        for b in (B1, B2):
            host, card = ((1.0 - b ** torch.tensor(float(t), device=d)).cpu()
                          for d in ("cpu", dev))
            print(f"1 - {b} ** {t}: host {host.item()!r} card "
                  f"{card.item()!r} equal {torch.equal(host, card)}")
    gen = torch.Generator().manual_seed(0)
    n = 1 << 22
    g = torch.randn(n, generator=gen) * 1e-3
    p = torch.randn(n, generator=gen) * 0.02
    m, v = (1 - B1) * g, (1 - B2) * g * g
    lr = torch.tensor(LR)
    bc1, bc2 = (1.0 - torch.tensor(b, dtype=torch.float32) for b in (B1, B2))
    host = update(m, v, p, lr, bc1, bc2)
    card = update(*(x.to(dev) for x in (m, v, p, lr, bc1, bc2)))
    for k in host:
        print(f"{k:10s}: {int((host[k] != card[k].cpu()).sum())} of {n} "
              "elements differ between host and card")
    vh, mh, den = host["v / bc2"], host["m / bc1"], host["+ eps"]
    root64 = vh.double().sqrt().float()
    quot64 = (mh.double() / den.double()).float()
    alone = {"sqrt": (vh.sqrt(), vh.to(dev).sqrt().cpu(), root64),
             "mh / den": (mh / den, (mh.to(dev) / den.to(dev)).cpu(),
                          quot64)}
    for k, (h, c, exact) in alone.items():
        print(f"{k} alone on the host's inputs: {int((h != c).sum())} "
              f"differ; host against float64 rounded {int((h != exact).sum())}"
              f", card against float64 rounded {int((c != exact).sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
