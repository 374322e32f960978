"""How far the JAX package's and the port's float32 evaluations of
zamba2-7b lie from the exact logits at full width, by depth, on the CPU:
the second witness beside ``scripts/torch_hybrid_conditioning.py`` (the
port alone) that float32 rounding, not either implementation, is what
grows with depth at this random init.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/hybrid_float32_witness.py \\
        [--depths 7,13] [--seq 512]

For each depth (the first n layers' pattern: groups of 6 Mamba2 layers
and the shared block, then the tail) the JAX package's own init (seed 0)
serves one prompt of ``--seq`` tokens (``TokenPipeline`` seed 0) through
its ``prefill`` in float32 (plain paths); the port's ``prefill`` runs on
the same weights (``from_jax_params``) in float32 on the CPU; and the
exact logits come from ``tests/_hybrid_exact.py`` (numpy, float64, the
Mamba2 layers as their sequential recurrence, independent of both
packages).  Printed per depth: the largest |difference| of the last
position's logits over their largest |logit|, for each float32 run
against the exact logits and for the two float32 runs against each other.
At 13 layers the weights take 5.8 GB in float32, held twice while the
port's copy is made (~13 GB of host memory at the peak); about two
minutes on 8 cores.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import sys
import time

import numpy as np

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(_ROOT, "src"))
sys.path.insert(0, os.path.join(_ROOT, "tests"))


def rel(a, b) -> float:
    """Largest |a - b| over the largest |b|, the worst row."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depths", default="7,13")
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)
    import jax
    import jax.numpy as jnp
    import torch
    from repro import configs as jcfg
    from repro.models import lm as JL
    from repro.models.api import get_model as jax_get_model

    from _hybrid_exact import logits as exact_logits
    from repro_torch import configs as tcfg
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import lm as L
    from repro_torch.models.params import from_jax_params

    jbase = dataclasses.replace(jcfg.get_config("zamba2-7b"),
                                dtype="float32")
    tbase = dataclasses.replace(tcfg.get_config("zamba2-7b"),
                                dtype="float32")
    toks = np.asarray(TokenPipeline(tbase, 1, args.seq, seed=0)
                      .batch_at(0)["tokens"])
    max_len = args.seq + 64
    print(f"zamba2-7b at full width, 1 x {args.seq} tokens, prefill "
          f"logits of the last position; jax {jax.__version__}, torch "
          f"{torch.__version__}, on the CPU", flush=True)
    for depth in (int(x) for x in args.depths.split(",")):
        t0 = time.perf_counter()
        jc = dataclasses.replace(jbase, n_layers=depth)
        tc = dataclasses.replace(tbase, n_layers=depth)
        jp = jax_get_model(jc).init(jc, jax.random.PRNGKey(0))
        _, jl = jax.jit(lambda p, t: JL.prefill(jc, p, t, max_len))(
            jp, jnp.asarray(toks))
        jl = np.asarray(jl)
        exact = exact_logits(jc, jp, toks)[:, -1]
        tp = from_jax_params(jp, device="cpu")
        del jp
        gc.collect()
        with torch.no_grad():
            _, tl = L.prefill(tc, tp, torch.from_numpy(toks), max_len)
        tl = tl.numpy()
        del tp
        gc.collect()
        print(f"depth {depth:2d}: from the exact logits, the JAX package "
              f"{rel(jl, exact):.3e}, the port {rel(tl, exact):.3e}; the "
              f"port from the JAX package {rel(tl, jl):.3e} of the row's "
              f"max |logit| (max |logit| {float(np.abs(exact).max()):.3e};"
              f" {time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
