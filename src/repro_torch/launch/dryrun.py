"""Multi-pod dry-run driver: the port's twin of ``repro.launch.dryrun``.

For every (architecture × input shape × mesh) cell: build one rank of
the production mesh (``launch.mesh.make_production_mesh``: dry, on the
``meta`` device, no process group), trace the real step (``train_step``
/ ``prefill`` / ``decode_step``: the same functions the drivers run) for
that rank with ``analysis.ops.trace``, and record

  * the bytes of its arguments, its outputs and the peak of live
    storages: whether the cell fits in HBM,
  * its FLOPs and unfused HBM traffic: the roofline's compute and memory
    terms,
  * the collectives its dry mesh recorded: the collective term.

Nothing is allocated and no card is needed, as the JAX package's dry run
compiles for host placeholder devices.  A failure to trace (a layout
that does not divide, an op with no meta kernel) is a bug in the port,
not in the cell: the cell's row is an ``error``.  Results append to a
JSONL so the run is resumable per cell.

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k \\
        --mesh single --out /tmp/d.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from ..analysis.ops import trace
from ..analysis.roofline import roofline_from_trace
from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..models.api import get_model, input_specs
from ..models.params import ParamTree, Struct, map_defs, struct_locals
from ..sharding.rules import MeshRules, Sharding
from ..train.optim import zero1_spec
from ..train.step import TrainConfig, make_train_step, state_structs
from .mesh import make_production_mesh


def apply_overrides(cfg, overrides: dict):
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def serve_param_structs(cfg, model, rules):
    """bf16 weight stand-ins for serve cells.  Under ``cfg.fsdp`` every
    parameter's spec is ZeRO-extended over the data axes (``zero1_spec``)
    and the model gathers each layer's weights where it uses them
    (``models.layout.serve_params``: ZeRO-inference).  Plain TP layout
    otherwise."""
    if not cfg.fsdp:
        return model.structs(cfg, rules, dtype=torch.bfloat16)

    def one(d):
        spec = zero1_spec(rules.spec(d.axes, d.shape), d.shape, rules)
        return Struct(tuple(d.shape), torch.bfloat16,
                      Sharding(rules.mesh, spec))

    return map_defs(one, model.param_defs(cfg))


def _whole(structs: dict) -> dict:
    """The global inputs: every rank takes the global batch and computes
    on its rows of it (``models.layout``)."""
    return {k: s.whole() for k, s in structs.items()}


def trace_cell(cfg, shape, mesh, *, tc: TrainConfig = TrainConfig()):
    """Trace one cell for the mesh's rank (the twin of ``lower_cell``);
    returns its ``analysis.ops.Artifact``."""
    rules = MeshRules(mesh, fsdp=cfg.fsdp)
    model = get_model(cfg)
    if shape.kind == "train":
        step = make_train_step(cfg, rules, tc)
        state = struct_locals(state_structs(cfg, rules, tc))
        state["params"] = ParamTree.from_tensors(state["params"],
                                                 requires_grad=True)
        batch = _whole(input_specs(cfg, shape, rules))
        return trace(step, state, batch)
    params = struct_locals(serve_param_structs(cfg, model, rules))
    if shape.kind == "prefill":
        inputs = _whole(input_specs(cfg, shape, rules))
        if cfg.family != "encdec":
            inputs = {k: v for k, v in inputs.items()
                      if k in ("tokens", "patches")}

        def fn(p, i):
            return model.prefill(cfg, p, i, shape.seq_len, rules)

        return trace(fn, params, inputs)
    # decode: one new token against a cache of seq_len
    cache = struct_locals(model.cache_structs(
        cfg, shape.global_batch, shape.seq_len, rules, dtype=torch.bfloat16))
    toks = input_specs(cfg, shape, rules)["tokens"].whole()

    def fn(p, c, t):
        return model.decode_step(cfg, p, c, t, rules)

    return trace(fn, params, cache, toks)


def shape_defaults(cfg, shape) -> dict:
    """Per-shape-kind config defaults (fit-tuning; overridable via --set).

    * train: microbatch the global batch so per-device activations (the
      logits/loss region above all) stay inside HBM;
    * serve (prefill/decode) on >=8B-param archs: fsdp=True — bf16 weights
      additionally sharded over the data axes and gathered per layer
      where they are used (ZeRO-inference).
    """
    out = {}
    if (shape.kind == "train" and cfg.microbatch == 1
            and shape.global_batch % 8 == 0):
        out["microbatch"] = 8
    if shape.kind in ("prefill", "decode") and cfg.n_params() >= 8e9:
        out["fsdp"] = True
    return out


def _n_devices(mesh) -> int:
    n = 1
    for s in mesh.sizes:
        n *= s
    return n


def run_cell(arch: str, shape_name: str, mesh, mesh_label: str,
             overrides: dict = None, verbose: bool = True) -> dict:
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    base = shape_defaults(cfg, shape)
    base.update(overrides or {})
    cfg = apply_overrides(cfg, base)
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_label,
           "n_devices": _n_devices(mesh)}
    runs, why = shape_applicable(cfg, shape)
    if not runs:
        row.update(status="skip", reason=why)
        return row
    t0 = time.time()
    try:
        art = trace_cell(cfg, shape, mesh)
        t_trace = time.time() - t0
        report = roofline_from_trace(
            art, arch=arch, shape=shape, mesh_name=mesh_label,
            n_devices=_n_devices(mesh), cfg=cfg)
        if verbose:
            print(f"  trace: arg={art.argument_bytes / 1e9:.3f}GB "
                  f"out={art.output_bytes / 1e9:.3f}GB "
                  f"peak={art.peak_bytes / 1e9:.3f}GB "
                  f"(fits={report.fits}) ops={art.profile.n_ops} "
                  f"kernels={art.profile.kernel_calls()}")
            print(f"  {report.row()}")
        row.update(status="ok", trace_s=round(t_trace, 2),
                   **report.to_dict())
    except Exception as e:  # a failure here is a bug in the port
        row.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return row


def iter_cells(archs, shapes):
    for arch in archs:
        for shape in shapes:
            yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id or comma list or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape name or comma list or 'all'")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already in --out")
    ap.add_argument("--set", action="append", default=[],
                    metavar="K=V", help="ModelConfig overrides (perf knobs)")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = (list(SHAPES) if args.shape == "all"
              else args.shape.split(","))
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                if line.strip():
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("1pod", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("2pod", make_production_mesh(multi_pod=True)))

    n_ok = n_skip = n_err = 0
    with open(args.out, "a") as f:
        for label, mesh in meshes:
            for arch, shape in iter_cells(archs, shapes):
                if (arch, shape, label) in done:
                    continue
                print(f"[dryrun] {arch} × {shape} × {label} "
                      f"({_n_devices(mesh)} devices, rank {mesh.rank})",
                      flush=True)
                row = run_cell(arch, shape, mesh, label, overrides)
                if overrides:
                    row["overrides"] = overrides
                f.write(json.dumps(row) + "\n")
                f.flush()
                st = row["status"]
                n_ok += st == "ok"
                n_skip += st == "skip"
                n_err += st == "error"
                if st == "error":
                    print(f"  ERROR {row['error']}", flush=True)
                elif st == "skip":
                    print(f"  {row['reason']}", flush=True)
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_err} error")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
