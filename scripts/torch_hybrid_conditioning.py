"""How far two correct float32 evaluations of zamba2-7b (or xlstm-125m,
seamless-m4t-large-v2, h2o-danube-1.8b, mistral-nemo-12b, mixtral-8x7b
or internvl2-76b) lie apart at full width, by depth: the ground of
``chip_smoke.py`` phases 16b's, 17b's, 18b's, 20a/b's and 21b/c's fp32
gates.

    python scripts/torch_hybrid_conditioning.py [--device cuda|cpu]
        [--arch zamba2-7b|xlstm-125m|seamless-m4t-large-v2|
                h2o-danube-1.8b|mistral-nemo-12b|mixtral-8x7b|
                internvl2-76b]
        [--depths 7,13,25,49,81] [--seq 512]

For each depth (the first n layers' pattern: groups of 6 Mamba2 layers
and the shared block, then the tail; for xlstm-125m groups of 3 mLSTM
blocks and an sLSTM block, then the tail; for seamless-m4t-large-v2 n
encoder and n decoder layers, the prompt's ``--seq`` frames encoded
beside 16 tokens; for the dense and MoE archs the first n layers, and a
prompt 64 tokens longer than a sliding window by default, so that the
window is in force; internvl2-76b's prompt follows its 256 patch
embeddings), the same seeded weights
(``Model.init``, seed 0) serve one prompt of ``--seq`` tokens
(``TokenPipeline`` seed 0) through ``prefill`` three ways: float32 with
the kernels (``attn_impl="pallas"``, ``use_pallas=True``; on the card
only), float32 on the plain paths, and float64 on the plain paths
(the model's ``dtype="float64"``: every float32 step of the model then
runs in float64, ``models.common.wide``; the weights are the same
float32 draws, widened).  Printed per depth: the largest |difference|
of the last position's logits over their largest |logit|, for kernels
on against off, and for each float32 run against float64.  The weights
of one precision at a time live on the device: at 81 layers 27 GB in
float32, 54 GB in float64 (the card's 80 GB; on the CPU ~60 GB of host
memory, so take smaller depths there); mistral-nemo-12b's 40 layers take
98 GB in float64, so its depths stop at 16 (48 GB).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def logits(cfg, params, inputs, max_len, dtype=None):
    """The prefill's last-position logits, in float64 on the host."""
    from repro_torch.models.api import get_model
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=str(dtype).removeprefix("torch."))
    _, lg = get_model(cfg).prefill(cfg, params, inputs, max_len)
    return lg.double().cpu()


def rel(a, b) -> float:
    """Largest |a - b| over the largest |b|, the worst row."""
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1)).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="zamba2-7b",
                    choices=["zamba2-7b", "xlstm-125m",
                             "seamless-m4t-large-v2", "h2o-danube-1.8b",
                             "mistral-nemo-12b", "mixtral-8x7b",
                             "internvl2-76b"])
    ap.add_argument("--depths", default=None,
                    help="default: 7,13,25,49,81 (zamba2-7b), 4,8,12 "
                         "(xlstm-125m), 2,4,8,16 (mistral-nemo-12b), "
                         "1,2,4 (mixtral-8x7b, internvl2-76b), "
                         "2,4,8,16,24 (seamless-m4t-large-v2, "
                         "h2o-danube-1.8b)")
    ap.add_argument("--seq", type=int, default=None,
                    help="default: 512, or the window + 64 where a dense "
                         "or MoE arch has one")
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.models.api import get_model

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = get_config(args.arch)
    depths = args.depths or {"zamba2-7b": "7,13,25,49,81",
                             "xlstm-125m": "4,8,12",
                             "mistral-nemo-12b": "2,4,8,16",
                             "mixtral-8x7b": "1,2,4",
                             "internvl2-76b": "1,2,4"}.get(
                                 args.arch, "2,4,8,16,24")
    if args.seq is None:
        args.seq = (base.window + 64 if base.family in ("dense", "moe")
                    and base.window else 512)
    encdec = base.family == "encdec"
    batch = TokenPipeline(base, 1, args.seq, seed=0).batch_at(0)
    inputs = ({"tokens": batch["tokens"][:, :16], "frames": batch["frames"]}
              if encdec else {"tokens": batch["tokens"]})
    if base.frontend == "patch":
        inputs["patches"] = batch["patches"]
    max_len = args.seq + 64 + (base.frontend_len
                               if base.frontend == "patch" else 0)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    front = (f" after {base.frontend_len} patch embeddings"
             if base.frontend == "patch" else "")
    print(f"{args.arch} at full width, 1 x {args.seq} "
          f"{'frames and 16 tokens' if encdec else 'tokens'}{front}, prefill "
          f"logits; on {where}", flush=True)
    for depth in (int(x) for x in depths.split(",")):
        t0 = time.perf_counter()
        off = dataclasses.replace(base, n_layers=depth, dtype="float32",
                                  attn_impl="blocked", use_pallas=False,
                                  **({"enc_layers": depth} if encdec else {}))
        model = get_model(off)

        def draw(dtype):
            return model.init(off, torch.Generator(device=dev)
                              .manual_seed(0), dtype=dtype, device=dev)
        params = draw(torch.float32)
        lg_off = logits(off, params, inputs, max_len)
        lg_on = None
        if dev.type == "cuda":
            on = dataclasses.replace(off, attn_impl="pallas",
                                     use_pallas=True)
            lg_on = logits(on, params, inputs, max_len)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        params = draw(torch.float64)
        lg64 = logits(off, params, inputs, max_len, torch.float64)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        line = (f"depth {depth:2d}: float32 plain from float64 "
                f"{rel(lg_off, lg64):.3e}")
        if lg_on is not None:
            line += (f", kernels from float64 {rel(lg_on, lg64):.3e}, "
                     f"kernels on against off {rel(lg_on, lg_off):.3e}")
        print(f"{line} of the row's max |logit| (max |logit| "
              f"{float(lg64.abs().max()):.3e}; "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
