"""Training driver of the PyTorch port:

    python -m repro_torch.launch.train --arch <id> [--smoke]
        [--device cuda|cpu]

The twin of ``repro.launch.train``, with the same flags and printed
lines: the train step (``train.step``, eager, in place), the
deterministic resumable token pipeline, atomic async checkpoints in the
JAX package's format, the heartbeat for the supervisor, ``--resume
auto|N`` and the ``--crash-at`` / ``--hang-at`` fault injection.  It runs
on the card unless ``--device cpu``, and raises without one.  The
weights are drawn from ``torch.Generator(device).manual_seed(seed)``, so
a fresh run does not start from the JAX driver's weights; a resumed run
continues whatever checkpoint it finds, also one the JAX driver wrote.
Metrics are read to the host on log rows only (each read waits for the
card).

As the JAX driver, it always trains over a ``(data, model)`` mesh of the
ranks there are, ``--model-shards`` of them on ``model``, with the state
in ``train.step.state_shardings``'s ZeRO-1 layout; one rank alone makes a
``(1, 1)`` mesh, which computes what no mesh computes, bit for bit.
Several ranks come from ``torchrun``:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch h2o-danube-1.8b --smoke --model-shards 2 --device cpu

Each rank takes ``cuda:LOCAL_RANK`` (modulo the cards there are; NCCL
when every rank has a card of its own, else a gloo group staged through
host memory), or the CPU with ``--device cpu``.  Every rank takes part in
each checkpoint (rank 0 writes the gathered arrays) and in the crash and
hang injection; rank 0 alone prints, beats the heartbeat and writes
``--metrics-out``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="",
                    help="'auto' or a step number")
    ap.add_argument("--heartbeat", default="")
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="fault injection: hard-exit at this step")
    ap.add_argument("--hang-at", type=int, default=-1,
                    help="fault injection: stop heartbeating at this step")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config, get_smoke_config
    from ..train.step import check_trainable
    from .mesh import init_distributed

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, microbatch=args.microbatch)
    check_trainable(cfg)
    joined = not torch.distributed.is_initialized()
    try:
        dev = init_distributed(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (on the command line: --device cpu)") \
            from e
    try:
        return _train(args, cfg, dev)
    finally:
        if joined and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, cfg, dev) -> int:
    import torch

    from ..data.tokens import TokenPipeline
    from ..sharding import MeshRules
    from ..train.checkpoints import CheckpointManager
    from ..train.fault_tolerance import beat
    from ..train.step import (TrainConfig, from_jax_state, init_train_state,
                              jit_train_step, state_shardings)
    from .mesh import make_local_mesh

    mesh = make_local_mesh(model=args.model_shards, device=dev)
    rules = MeshRules(mesh, fsdp=cfg.fsdp)
    lead = mesh.rank == 0
    tc = TrainConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                     total_steps=args.steps)

    pipeline = TokenPipeline(cfg, args.global_batch, args.seq,
                             seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    shard = state_shardings(cfg, rules, tc)
    state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev,
        shardings=shard)
    start = 0
    if mgr is not None and args.resume:
        want = None if args.resume == "auto" else int(args.resume)
        if mgr.latest_step() is not None or want is not None:
            start, host = mgr.restore(want, template=state, shardings=shard)
            del state
            state = from_jax_state(host, dev)
            del host
            if lead:
                print(f"[train] resumed from step {start}", flush=True)
    step_fn = jit_train_step(cfg, rules, tc)

    t0 = time.time()
    metrics_log = []
    for step in range(start, args.steps):
        if step == args.crash_at:
            if lead:
                print(f"[train] injected crash at step {step}", flush=True)
            os._exit(42)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipeline.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        if lead and args.heartbeat and step != args.hang_at:
            beat(args.heartbeat, step)
        if args.hang_at >= 0 and step >= args.hang_at:
            time.sleep(3600)             # simulated straggler
        if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
            m = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            row = {"step": step + 1, "loss": m["loss"],
                   "grad_norm": m["grad_norm"], "lr": m["lr"],
                   "tok_per_s": args.global_batch * args.seq
                   * args.log_every / max(dt, 1e-9)}
            metrics_log.append(row)
            if lead:
                print(f"[train] step {row['step']:5d} "
                      f"loss {row['loss']:.4f} "
                      f"gnorm {row['grad_norm']:.3f} "
                      f"lr {row['lr']:.2e} {row['tok_per_s']:.0f} tok/s",
                      flush=True)
            t0 = time.time()
        if (mgr is not None and args.ckpt_every
                and (step + 1) % args.ckpt_every == 0):
            mgr.save(step + 1, state, block=False,
                     metadata={"arch": args.arch, "seq": args.seq,
                               "global_batch": args.global_batch},
                     shardings=shard)
    if mgr is not None:
        mgr.wait()
        mgr.save(args.steps, state,
                 metadata={"arch": args.arch, "final": True},
                 shardings=shard)
    if lead and args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_log, f)
    if lead:
        print("[train] done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
