#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:

1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and print the build time and
   what ``ptxas`` reports;
2. run each kernel on the card at the main paths' shapes and hold it
   against its plain PyTorch version on the same inputs: the mining
   kernels bit for bit at T = 816,197 (the BibSonomy table), with a uint32
   wraparound case and 1-, 2-word and 64-bit keys; ``segment_reduce``'s
   (T + 1) entry (what ``masked_prefix`` takes) and inputs off 16 bytes;
   ``radix_histogram`` also on all-equal keys, views off 16 bytes and T
   mod 4 = 3, timed on the skewed BibSonomy keys and on uniform 64-bit
   signature words, beside the two increment designs it was chosen
   against (``probe_radix_histogram.RIVAL_DESIGNS``); ``radix_rank``'s
   rank-only entry also with every digit equal, 90% of one digit and at
   one and two tiles +- 1, and its fused pass (the main path's entry)
   through every pass of the three keys' plans, then timed at T =
   816,197 beside its plain version, the per-pass sequence it replaced
   and stable ``torch.sort`` with gathers; the ``ptxas`` report of the
   rank sweep and of the ``rmsnorm`` vector kernels; ``flash_attention``
   in fp32 within rtol = atol = 2e-5 of its plain version, and in bf16
   (where P enters the tensor cores rounded to bf16) elementwise against
   a float64 evaluation on the same inputs, |o - o64| <= 2**-7 (|o64| +
   P64 |V| / l64) + 1e-5 (``ref.flash_bf16_gate``), at granite-moe-3b-
   a800m's attention shape (B 4 x Hq 24 / Hkv 8 x S 2048 x D 64, causal),
   at D 128 with GQA group 2, with a window of 512 (causal and not), with
   q_offset = Skv - Sq, at a ragged S of 200 and at every head dim with
   Sq not a multiple of the 64-row query tile; time the kernel, the plain
   version and one PyTorch library call computing the same function,
   beside the bound;
   ``signature`` and ``tricluster_density`` bit for bit at the JAX
   package's test shapes, with a uint32 wraparound case;
3. mine full-size BibSonomy (816,197 triples; 2,337 x 67,464 x 28,920)
   with ``BatchMiner(device="cuda")``: launch counts of the run, warm time,
   and every ``PipelineResult`` leaf against ``sort_backend="lax"`` on the
   card and, on a small context, against the CPU run;
4. the same for ``NOACMiner(delta=1.0)`` on the MovieLens-1M shape
   (1,000,209 ratings; 6,040 x 3,952 x 5 stars);
5. the CLI twin, ``--dataset imdb --backend batch``, ``--backend
   reference`` and ``--backend distributed --strategy shuffle`` (rc 0, the
   same cluster count) and an unknown backend (rc 2);
6. MoE routing telemetry at full width: granite-moe-3b-a800m (32 layers,
   3,298,793,472 parameters, random weights from a seeded generator) over
   4 x 2048 tokens with ``attn_impl="pallas"`` — 32 ``flash_attention``
   launches — then ``routing_context`` and ``BatchMiner(theta=0.2)``: warm
   times, device idle share, the share of routes that agree with
   ``attn_impl="blocked"`` (bf16: an agreement share, not equality), and
   the mining on the card against the mining on the CPU, leaf for leaf;
7. the granite-moe and mixtral smoke routing passes in fp32 through the
   kernel on the card: routes identical to the CPU's plain run;
8. the dense validation path: ``BatchMiner(device="cuda")`` (prime), then
   ``dense_tensor`` -> ``fibers`` -> ``set_signature`` (the ``signature``
   kernel) and ``exact_density_dense`` (the ``tricluster_density``
   kernel) on the IMDB shape (250 x 700 x 22), K1 (60^3 minus the
   diagonal) and the MovieLens-1M shape (356,877 distinct rows over
   6,040 x 3,952 x 5), all at full size: the fibers' signatures mix to
   the pipeline's ``sig_lo``/``sig_hi`` for every tuple and their sums are
   its cardinalities; the kernels equal their plain versions on the card
   bit for bit; every kept IMDB and K1 cluster's exact numerator equals
   ``core.reference.exact_density`` x volume (numpy, on the host) and its
   density matches within rel 1e-5; at the MovieLens shape every
   numerator is at least the generating-tuple count, and the phase times
   both kernels (the JSON line's entries), their plain versions and the
   whole dense path, beside the bounds and the peak device memory, with
   ``tricluster_density``'s TOP/s, its ``ptxas`` report and, as a
   yardstick of the product alone (not the same function), cuBLAS's int8
   product of the same shape (``torch._int_mm``, C written, no epilogue);
9. LM serving.  (a) ``decode_attention`` and ``rmsnorm`` against their
   plain versions at every shape of the JAX package's kernel tests in
   fp32 and bf16 (fp32 rtol = atol = 2e-5, its tolerance; bf16 one ulp of
   each output, rtol 2**-7 + atol 1e-5, tighter than its 2e-2) and at the
   serving run's shapes (decode B 4 x Hq 24 / Hkv 8 x D 64 over a
   (B, 4096, Hkv, D) ring view, kv_len 2049 and 4096 and at the
   boundaries of the split-KV ranges, k x splitlen +- 1; one split at
   B x Hkv = 264; D 80; RMSNorm 4 x 2046 and 4 rows of D 1536, whose
   plans must be the 16-byte vector path); at each decode shape also
   ``return_lse`` (the same O, the log-sum-exp within 2e-5 of the plain
   version's) and ``kv_len`` 0 (o = 0, lse = -inf, no launch); each
   timed beside its bound,
   its plain version and one PyTorch call (RMSNorm at the prefill and at
   the decode shape; SDPA
   over the kv_len slice with ``enable_gqa``; ``F.rms_norm``); decode
   also L2-cold (``cold_ms``, ``library_cold_ms``), each call on the next
   of six distinct rings (201 MB), as serving reads each layer's cache.
   (b) granite-moe-3b-a800m at full width and depth, random fp32 weights
   from a seeded generator, bf16,
   ``attn_impl="pallas"`` and ``use_pallas=True``: ``ServeEngine``
   (max_len 4096) over 4 ragged prompts of about 2048 tokens, 32 new
   tokens greedy — launch counts (32 decode launches a step; 65 RMSNorm
   launches in the prefill and 65 a step, all on the vector path),
   prefill and decode ms,
   tokens/s, idle share, peak memory, the decode step's profile, the
   bf16 tokens' agreement with the plain path (reported); then the fp32
   gate: kernels on against off (``attn_impl="blocked"``,
   ``use_pallas=False``), teacher-forced on the same tokens, every
   step's logits within 1e-3 of the step's max |logit|.  (c) ring wrap:
   danube-smoke and mixtral-smoke (window 32) in fp32, 40-token prompts
   and 48 decode steps, kernels on against off within rtol = atol = 2e-5
   at every step;
10. out-of-core and streaming mining (``phase10``), with
   ``use_kernels=None`` on the card: (a) BibSonomy prime and (b) the
   MovieLens-1M shape NOAC (delta 1) through ``mine_chunked`` at
   ceil(T/8) rows a chunk, ``mine_windowed`` at ceil(T/8) rows a window
   and at an odd budget below the largest key segment of mode 0, every
   ``PipelineResult`` leaf equal to the in-core result on the card, the
   windowed run's peak device bytes below the in-core run's; (c)
   ``StreamingMiner`` over the BibSonomy table in 8 chunks, a seeded 1%
   upserted and another 1% deleted, a snapshot after each step, the last
   equal to a batch mine of the survivors, to a ``full_remine`` snapshot,
   to a windowed snapshot and to a snapshot after ``save_checkpoint`` ->
   ``load_checkpoint`` -> ``RunStore.restore``; every run's launches
   held against the window plan (``segment_reduce`` = modes x windows),
   with warm times, busy shares, host run-sort, per-window and snapshot
   times;
11. distributed mining (``phase11``, ``core.distributed`` over
   ``torch.distributed``): (a) an NCCL group of one rank, BibSonomy prime
   and the MovieLens-1M shape NOAC (delta 1) under ``replicate`` and
   ``shuffle``, every ``DistributedResult`` leaf equal to the in-core
   result, overflow 0, launches from the key plans (the shuffle's owners
   sort ``total_bits + 1`` bits), warm ms, tuples/s and idle share beside
   phases 3-4; (b) BibSonomy ingested in 8 chunks into the per-shard run
   stores, then ``snapshot()``, ``snapshot(full_remine=True)``,
   ``serving_snapshot()`` and a windowed ``serving_snapshot()`` at
   ceil(T/8) rows, each equal to the in-core result (kept signatures and
   per-tuple leaves), with their ms and ``stream_stats``; (c) four gloo
   ranks spawned on the one card (NCCL takes one rank a card; the gloo
   collectives stage their buffers through host memory), both contexts
   under ``shuffle``, rank 0's gathered result against the in-core miner
   (``sig_lo``, ``sig_hi``, ``gen_count``, ``volume``, ``density``, the
   unique signature sets, ``n_clusters`` and the kept count), with each
   mode's partition (range or hash fallback) and the final
   ``capacity_factor``;
12. the cluster service (``phase12``, ``serve`` and ``obs``) over the
   first thirty-second of BibSonomy's table (25,507 rows;
   ``SERVICE_ROWS`` says why): (a) ``TriclusterService(backend="streaming",
   delta_index=True)`` with an enabled ``obs`` hub, the rows in 8
   chunks, ``start()``, 8 rounds of 0.1% upserts each with a
   ``refresh()``: at every version the delta index equals the full build
   of the same result array for array, and ``query_batch`` of 4,096
   entities (k 10) equals ``BatchQuerier`` over it; the last index equals
   those built from ``full_remine``, an in-core ``BatchMiner``,
   ``mine_chunked`` and ``mine_windowed`` of the live rows on the card;
   the launches of the 9 swaps, the swap, mine, index-build, readback
   and query times from the hub and its spans, and the stage histograms
   the miners' hooks filled; (b) the same write stream through
   ``backend="distributed"`` on an NCCL group of one rank, its kept
   signature words and top-k hits equal to (a)'s at every version; (c)
   the CLI's ``--top-k 5`` and ``--query-entity 207 --query-mode 0`` on
   the card and on the CPU, the same ranked lines; (d) a service with
   ``recover_dir`` stopped after writes, and a successor restored from
   its checkpoint and WAL publishing the same signatures and scores;
13. the multi-process serving plane (``phase13``, ``serve.{shm,protocol,
   router,supervise}`` and ``launch.cluster_serve``): (a) a card-backed
   writer publishing to ``/dev/shm`` and a ``ReplicaService`` of it,
   each behind ``make_server``, over phase 12's rows: the smoke client's
   sequence (scalar, a batch of 4,096, top-k with components, signature
   round-trip, upsert, refresh, ``at_least_version``) answered equally by
   both endpoints and the service in-process, 3 / 1 / 8 launches a swap,
   publish, attach and HTTP times; (b) ``python -m
   repro_torch.launch.cluster_serve --shards 2 --replicas 2 --device
   cuda`` over ``PLANE_ROWS`` BibSonomy-shaped rows: ``nvidia-smi``
   lists CUDA contexts for this process and the writers only, the
   router's top-k and a batch equal in-process card-backed shards
   merged, each writer's launches (its ``/metrics``) are a swap's times
   its publishes, and ``--smoke-client`` passes; (c) the plane with a
   writer killed at its first write after the preload: restarted by the
   supervisor, recovered from checkpoint and WAL on the card, the write
   read back at its version.  No shared-memory segment outlives a plane.
14. training (``phase14``, ``train.{optim,step,checkpoints,
   fault_tolerance}`` and ``launch.train``; no kernel on its path, as in
   the JAX package): (a) ``launch.train.main`` trains granite-moe-3b-
   a800m at full width and depth (bf16 compute over fp32 master
   parameters, ``remat="block"``, ``attn_impl="blocked"``) for
   ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens: each
   step's loss, grad norm and lr (finite), the warm step time and tokens/s
   (steps 2 on, each ending in the log row's read), the peak device
   bytes beside the memory reckoning, zero kernel launches, then one more
   step under the profiler (device busy share, time by PyTorch op); (b)
   an fp32 gate at ``GATE_LAYERS`` depth and full width: one step of the
   same seeded state and batch (1 x 512 tokens) on the card and on the
   CPU, no MoE route differing, the loss within rtol 1e-5 and the grad
   norm 5e-4, every leaf of ``m`` and ``v`` within 5e-3 and 1e-2 of the
   leaf's largest magnitude (float32's own error here,
   ``scripts/torch_train_conditioning.py``), the card's parameter update
   bit for bit AdamW applied on the host to the card's own moments and
   bias corrections, and the parameters against the CPU's where the
   update is not the sign of rounding noise; (c) ``launch.train`` at smoke
   size on the card (h2o-danube-1.8b): 6 steps straight against a resume
   of its step-3 checkpoint for 3 more (the rows of steps 4-6 and every
   leaf of the step-6 states equal), and a checkpoint
   written on the card restored with ``device="cpu"`` leaf for leaf
   equal to the state it saved; (d) ``examples/torch_fault_tolerance_demo
   .py`` on the card: an injected crash under the ``Supervisor``, a
   restart, a resume from the last checkpoint, exit 0;
15. the model on a device mesh (``phase15``, ``sharding``, ``models``,
   ``train``, ``serve``): (a) an NCCL group of one rank, mesh (1, 1):
   granite-moe-3b-a800m at full width and depth serving the phase-9b
   prompts (8 new tokens) through both kernels, tokens and every logit
   row bit for bit equal to ``rules=None``, and two training steps at
   14a's shape whose loss and grad norm equal two ``rules=None`` steps
   (held to two ``rules=None`` runs' own spread if those differ); (b)
   two gloo ranks on ``cuda:0`` (collectives staged through host
   memory), mesh (data 1, model 2), granite-moe at full width and depth
   in bf16 with both kernels: 4 prompts of ~1,024 tokens, 16 new tokens,
   per rank prefill and decode ms, peak device bytes and the staged
   collectives' calls and bytes, ``decode_attention`` and ``rmsnorm``
   launching on every rank as many times as the plan gives, the greedy
   tokens' agreement with the one-rank card run (reported), and an fp32
   gate at ``GATE_LAYERS`` depth: the prefill's and each decode step's
   logits within 2e-5 of the row's max of the one-rank card run; (c)
   four gloo ranks, mesh (2, 2), granite-moe at full width and
   ``GATE_LAYERS`` depth in fp32, 2 x 512 tokens, ZeRO-1: three steps
   and one with the ``gspmd`` MoE dispatch, and one fsdp step from a
   fresh state; every rank also runs the one-rank card step from the
   same state on the mesh's routes (a route may differ only at a near
   tie: 1e-4 of the row's router probability), holds its blocks against
   that state's after each step (loss rtol 1e-5, grad norm 5e-4, ``m``
   and ``v`` 1e-2 of the leaf's max; at a state's first step the
   parameters 1e-3 lr where the update is not rounding noise; at every
   step each block's update AdamW of its own moments bit for bit) and
   takes them for the next; the host-staged step ms; and
   a checkpoint the four ranks saved, restored whole on each rank, byte
   for byte equal block for block to the live state.

Before the last line it prints the card's name and power limit
(``nvidia-smi``) and one JSON line ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import contextlib
import datetime
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 rate
#: outside the tensor cores (used for the integer ALU work too) and the
#: dense bf16 and int8 tensor-core rates (the int8 rate bounds work on
#: 0/1 operands, which int8 products with int32 sums compute exactly).
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989.4e12
INT8_TENSOR_OPS_PER_S = 1978.9e12

GRANITE_PARAMS = 3_298_793_472

#: Depth of phase 9b's end-to-end fp32 logits gate.  At full depth an ulp
#: of difference flips MoE top-k routes (15 of 65,472 prefill routes at
#: layer 1, 61,860 at layer 31, on an H100) and the flips cascade, so the
#: logits of two correct implementations part.  In a two-layer model a
#: flip in the last layer changes only that token's own output, so it can
#: reach the logits only at the positions they read (the last prompt
#: position, the decoded tokens).  The gate relies on no near-tied route
#: falling on those positions for this seed; the per-launch float64 checks
#: at full depth are the guarantee.
GATE_LAYERS = 2

BIB_T = 816_197
ML_T = 1_000_209

#: Phase 14a's run: granite-moe-3b-a800m at full width and depth, global
#: batch x sequence tokens a step (4,096; the memory reckoning below is
#: for this size), steps.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean ms per call on the card's timeline (CUDA events around
    ``iters`` back-to-back calls, after ``warm`` calls)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: Clock cycles of the first sleep kernel that ``queued_ms`` puts ahead of
#: the timed calls (about 10 ms on an H100), quadrupled on each retry.
SLEEP_CYCLES = 20_000_000


def queued_ms(fn, iters: int = 20):
    """(mean device ms per call, queued) of ``iters`` back-to-back calls
    timed by CUDA events behind a sleep kernel: the host enqueues every
    call while the card sleeps, so the interval holds the calls' device
    work and no host launch gaps.  ``queued`` says whether the host did
    finish enqueueing before the card reached the start event (a call
    that waits for the card cannot); the sleep is lengthened up to three
    times when it did not."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            break
        cycles *= 4
    return start.elapsed_time(end) / iters, queued


def device_ms(fn, iters: int = 10, warm: bool = True):
    """(device ms per call, {kernel name: device ms per call}, {PyTorch op:
    device ms per call of the kernels it launched itself}, complete) of
    every kernel, copy and fill that ``iters`` calls of ``fn`` put on the
    card, from one ``torch.profiler`` trace; (None, {}, {}, False) when it
    records no device time.  Kernels launched outside any PyTorch op (the
    port's own, through ``ctypes``) appear only by kernel name.
    ``complete`` says whether every activity appears a whole number of
    times per call: the trace has been seen to lose records of the port's
    kernels (2 of 10 kept), and an incomplete trace understates."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:          # no CUPTI where this runs
        log(f"profiler unavailable: {e}")
        return None, {}, {}, False
    by_name, seen = {}, {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            by_name[ev.name] = by_name.get(ev.name, 0.0) + us / iters / 1e3
            seen[ev.name] = seen.get(ev.name, 0) + 1
    complete = all(n % iters == 0 for n in seen.values())
    by_op = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CPU:
            continue                   # the kernels themselves: by_name
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            by_op[ev.key] = us / iters / 1e3
    total = sum(by_name.values())
    return ((total, by_name, by_op, complete) if total > 0
            else (None, {}, {}, False))


def measure(fn, iters: int = 20, warm: int = 3) -> dict:
    """``ms``: the device time per call, by CUDA events around calls
    queued behind a sleep (:func:`queued_ms`; ``source`` says whether the
    host kept ahead).  Not the profiler: its traces have lost records of
    the port's ctypes-launched kernels (2 of 10 ``signature`` launches
    kept; of ``tricluster_density``'s two kernels only the small one).
    ``call_ms``: CUDA events around back-to-back calls, host launch
    overhead included."""
    call = time_ms(fn, iters=iters, warm=warm)
    dev, queued = queued_ms(fn, iters)
    return {"ms": dev, "call_ms": call,
            "source": "queued events" if queued
            else "events, host not ahead"}


def bound(bytes_moved: float, ops: float, ops_per_s: float = ALU_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over ``ops_per_s`` (the ALU rate by default)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> int:
    """Largest |got - want| over int32 outputs read as uint32."""
    import torch
    g = got.to(torch.int64) & 0xFFFFFFFF
    w = want.to(torch.int64) & 0xFFFFFFFF
    return int((g - w).abs().max().item()) if g.numel() else 0


def ptxas_usage(log_text: str) -> dict:
    """{kernel entry: 'N registers, S bytes smem, spills'} from an
    ``nvcc -Xptxas -v`` log."""
    out, entry = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            for short in ("td_tile", "td_image", "td_finish"):
                if short in entry:
                    entry = short + ("<aligned>" if "ILb1E" in entry else
                                     "<bytes>" if "ILb0E" in entry else "")
            if "radix_rank_onesweep" in entry:
                entry = ("radix_rank_onesweep<fused>" if "ILb1E" in entry
                         else "radix_rank_onesweep<rank>")
            m = re.search(r"radix_hist_kernelILb(\d)ELi(\d)E", entry)
            if m:        # <16-byte loads, key words>
                entry = "radix_hist_kernel<{}, {} words>".format(
                    "vector" if m.group(1) == "1" else "scalar", m.group(2))
            if "sr_onesweep" in entry:
                entry = ("sr_onesweep<vector>" if "ILb1E" in entry
                         else "sr_onesweep<scalar>")
            m = re.search(r"rmsnorm_vecI(f|13__nv_bfloat16)"
                          r"(f|13__nv_bfloat16|S\d*_)Li(\d+)E", entry)
            if m:        # <x, w, vectors a lane>; a bf16 w repeats x's type
                entry = "rmsnorm_vec<{}, {}, {}>".format(
                    "f32" if m.group(1) == "f" else "bf16",
                    "f32" if m.group(2) == "f" else "bf16", m.group(3))
        elif entry and "spill" in line:
            out[entry] = line.strip()
        elif entry and "Used" in line:
            out[entry] = (out.get(entry, "") + "; "
                          + line.split("Used", 1)[1].strip()).lstrip("; ")
    return out


def leaves_equal(a, b, what: str) -> None:
    import dataclasses
    import torch
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"{what}: leaf {f.name} {tuple(x.shape)}/{x.dtype} vs "
              f"{tuple(y.shape)}/{y.dtype}")
        check(torch.equal(x.cpu(), y.cpu()), f"{what}: leaf {f.name} differs")


def route_agreement(a, b):
    """(share of equal (layer, token, slot) routes, share per layer)."""
    import numpy as np
    eq = np.asarray(a) == np.asarray(b)
    return float(eq.mean()), [float(x) for x in eq.reshape(eq.shape[0], -1)
                              .mean(1)]


def phase10(bib, ml, prime_ms: float, noac_ms: float) -> dict:
    """Phase 10: out-of-core and streaming mining on the card at full size.

    (a) BibSonomy prime and (b) the MovieLens-1M shape NOAC (delta 1):
    ``mine_chunked`` at ceil(T/8), ``mine_windowed`` at ceil(T/8) and at an
    odd budget below the largest key segment of mode 0, every leaf equal
    to the in-core result on the card.  (c) ``StreamingMiner`` over the
    BibSonomy table in 8 chunks, then a seeded 1% upserted and another 1%
    deleted, a snapshot after each step; the last equals a batch mine of
    the survivor table, a ``full_remine`` snapshot, a windowed snapshot
    and a snapshot after a checkpoint round trip.  Each run's launches are
    counted and held against the window plan; warm times, busy shares,
    host run-sort, per-window and snapshot times, and peak device bytes
    in-core against windowed are printed.  Returns {run: launch counts}."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import BatchMiner, NOACMiner, StreamingMiner
    from repro_torch.core import keys as K
    from repro_torch.core import memprobe as MP
    from repro_torch.core import pipeline as P
    from repro_torch.core import radix as RX
    from repro_torch.core import runs as RS
    from repro_torch.kernels import ops

    mining = ops.PATH_KERNELS["mining"]
    runs = {}

    def expect(windows=1, sorted_stage1=False, passes=0, n=3):
        """Launches of one mining run: per window a segment sweep per
        mode and one Stage-3 sort (a histogram, 8 fused passes); a Stage 1
        that sorts on the card adds a histogram per mode and ``passes``
        fused passes per mode."""
        return {"segment_reduce": n * windows,
                "radix_histogram": windows + (n if sorted_stage1 else 0),
                "radix_rank": 8 * windows + (n * passes
                                             if sorted_stage1 else 0)}

    def counted(label, fn, want):
        """Run ``fn`` once with the counts at 0 and check them against
        ``want`` (no other kernel, no plain version on the card)."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        res.keep.cpu()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        path = {k: counts[k] for k in mining}
        check(path == want, f"{label}: launches {path} != {want}")
        check(all(n == 0 for k, n in counts.items() if k not in mining),
              f"{label}: a kernel of another path was launched: {counts}")
        runs[label] = counts
        return res, ms

    def timed(label, fn, want, first_ms):
        """Two more warm runs (min of 3 with the counted one) and one under
        the profiler for the device busy share."""
        times = [first_ms]
        for _ in range(2):
            t0 = time.perf_counter()
            fn().keep.cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        busy, _, _, complete = device_ms(lambda: fn().keep.cpu(), iters=1,
                                         warm=False)
        best = min(times)
        share = ("busy not measured" if busy is None or not complete
                 else f"device busy {busy:.3f} ms (busy share "
                 f"{busy / best:.3f})")
        log(f"{label}: launches {want}; warm ms {[round(t, 3) for t in times]}"
            f" (min {best:.3f}); {share}")
        return best

    def equal_leaves(a, b, what, rows=None):
        """Every leaf equal (``rows``: the per-tuple leaves of the first
        ``rows`` tuples only — a padded snapshot against an unpadded
        table, whose sorted-order leaves shift by the pads)."""
        for name in P.PipelineResult.__dataclass_fields__:
            x, y = getattr(a, name), getattr(b, name)
            if rows is not None:
                if name in ("range_lo", "range_hi", "sorted_e", "perms"):
                    continue
                x, y = x[..., :rows], y[..., :rows]
            check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()),
                  f"{what}: leaf {name} differs")

    def peak_bytes(fn):
        """(result, device bytes allocated at the run's peak above what
        was allocated before it)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        res.keep.cpu()
        torch.cuda.synchronize()
        return res, torch.cuda.max_memory_allocated() - base

    def largest_segment(ctx, plan):
        keys = plan.pack_host(ctx.tuples, ctx.values if plan.with_values
                              else None) >> np.uint64(plan.seg_shift)
        return int(np.unique(keys, return_counts=True)[1].max())

    def out_of_core(tag, ctx, miner, args, kw, incore_ms):
        t = ctx.num_tuples
        incore, incore_peak = peak_bytes(lambda: miner(*args))
        b8 = math.ceil(t / 8)
        seg = largest_segment(ctx, miner.key_plans[0])
        odd = seg - 1 if (seg - 1) % 2 else seg - 2
        check(odd >= 1, f"{tag}: largest mode-0 segment {seg}")
        log(f"{tag}: T={t}, in-core warm {incore_ms:.3f} ms (phase "
            f"{3 if tag.endswith('prime') else 4}); largest mode-0 key "
            f"segment {seg} rows; budgets ceil(T/8) = {b8} and {odd}")
        # the host run sort alone, at the chunk budget
        t0 = time.perf_counter()
        store = RS.RunStore(miner.key_plans, incremental=True)
        for rows, vals in RS.iter_chunks(ctx.tuples, kw.get("values"), b8,
                                         with_values=miner.delta
                                         is not None):
            store.add(rows, vals)
        store.prepare()
        sort_ms = (time.perf_counter() - t0) * 1e3
        log(f"{tag}: host run sort of {t} rows in {math.ceil(t / b8)} "
            f"chunks (RunStore add + prepare): {sort_ms:.3f} ms")

        def chunked():
            return miner.mine_chunked(ctx.tuples, chunk_budget=b8, **kw)
        res, ms = counted(f"{tag} chunked", chunked, expect())
        equal_leaves(res, incore, f"{tag} chunked vs in-core")
        timed(f"{tag} chunked (budget {b8})", chunked, expect(), ms)
        peaks = {}
        for budget in (b8, odd):
            windows = RX.plan_windows(t, budget).n_windows
            label = f"{tag} windowed (budget {budget}, {windows} windows)"
            stamps = []
            probe = MP.MemProbe("cuda")

            def stamped(stage, probe=probe, stamps=stamps):
                stamps.append((stage, time.perf_counter()))
                probe(stage)

            def windowed(budget=budget, probe=None):
                return miner.mine_windowed(ctx.tuples, window_budget=budget,
                                           probe=probe, **kw)
            res, ms = counted(label, lambda: windowed(probe=stamped),
                              expect(windows))
            equal_leaves(res, incore, f"{label} vs in-core")
            # the time from one window's result to the next, host work
            # included (the first window of a stage also carries the
            # stage's host set-up)
            per_stage = {}
            for (_, t_a), (stage, t_b) in zip(stamps, stamps[1:]):
                per_stage.setdefault(stage, []).append((t_b - t_a) * 1e3)
            log(f"{label}: per-window ms " + ", ".join(
                f"{st} median {np.median(v):.3f} max {np.max(v):.3f}"
                for st, v in per_stage.items())
                + f"; MemProbe stage peaks {probe.report()['stages']}")
            timed(label, windowed, expect(windows), ms)
            _, peaks[budget] = peak_bytes(windowed)
        log(f"{tag}: peak device bytes above the start: in-core "
            f"{incore_peak}, windowed " + ", ".join(
                f"(budget {b}) {v} ({v / incore_peak:.3f} of in-core)"
                for b, v in peaks.items()))
        for b, v in peaks.items():
            check(v < incore_peak, f"{tag}: windowed (budget {b}) peak {v}"
                  f" >= in-core {incore_peak}")
        return incore

    t_phase = time.perf_counter()
    # (a) BibSonomy prime, (b) the MovieLens-1M shape NOAC
    bib_incore = out_of_core("phase 10a bibsonomy prime", bib,
                             BatchMiner(bib.sizes, device="cuda"),
                             (bib.tuples,), {}, prime_ms)
    out_of_core("phase 10b movielens noac", ml,
                NOACMiner(ml.sizes, delta=1.0, device="cuda"),
                (ml.tuples, ml.values), {"values": ml.values}, noac_ms)

    # (c) streaming over the BibSonomy table
    tag = "phase 10c streaming bibsonomy"
    t = bib.num_tuples
    sm = StreamingMiner(bib.sizes, device="cuda")
    step = math.ceil(t / 8)
    snap_ms = []
    for i, lo in enumerate(range(0, t, step)):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sm.add(bib.tuples[lo:lo + step])
        add_ms = (time.perf_counter() - t0) * 1e3
        check(sum(ops.launch_counts().values()) == 0,
              f"{tag}: ingestion launched a kernel")
        snap, ms = counted(f"{tag} snapshot {i + 1}", sm.snapshot, expect())
        snap_ms.append(ms)
        log(f"{tag}: chunk {i + 1}: add {add_ms:.3f} ms (host sort and "
            f"merge), snapshot of {sm.state.count} rows (cap "
            f"{len(snap.keep)}) {ms:.3f} ms")
    equal_leaves(snap, bib_incore, f"{tag} after 8 chunks vs in-core",
                 rows=t)
    rng = np.random.default_rng(2026)
    pick = rng.choice(t, 2 * (t // 100), replace=False)
    for what, fn in (("upsert", lambda: sm.upsert(
            bib.tuples[pick[:t // 100]])),
                     ("delete", lambda: sm.delete(
                         bib.tuples[pick[t // 100:]]))):
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        snap, ms = counted(f"{tag} snapshot after {what}", sm.snapshot,
                           expect())
        snap_ms.append(ms)
        log(f"{tag}: {what} of {t // 100} rows {host_ms:.3f} ms, snapshot of "
            f"{sm.state.count} rows {ms:.3f} ms")
    survivors = sm.state.table()[0].copy()
    batch = BatchMiner(bib.sizes, device="cuda")(survivors)
    equal_leaves(snap, batch, f"{tag} last snapshot vs batch of the "
                 "survivors", rows=survivors.shape[0])
    check(np.array_equal(P.kept_sig_words(snap), P.kept_sig_words(batch)),
          f"{tag}: kept signatures differ from the batch mine")
    snap_warm = timed(f"{tag} incremental snapshot", sm.snapshot, expect(),
                      snap_ms[-1])
    remine = expect(sorted_stage1=True,
                    passes=math.ceil(sm.key_plans[0].total_bits / 8))
    full, full_ms = counted(f"{tag} full_remine",
                            lambda: sm.snapshot(full_remine=True), remine)
    equal_leaves(full, snap, f"{tag} full_remine vs incremental")
    full_warm = timed(f"{tag} full_remine",
                      lambda: sm.snapshot(full_remine=True), remine, full_ms)
    sm.window_budget = step
    windows = RX.plan_windows(len(snap.keep), step).n_windows
    win, win_ms = counted(f"{tag} windowed snapshot", sm.snapshot,
                          expect(windows))
    equal_leaves(win, snap, f"{tag} windowed vs incremental")
    win_warm = timed(f"{tag} windowed snapshot", sm.snapshot,
                     expect(windows), win_ms)
    sm.window_budget = None
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/stream.ckpt"
        t0 = time.perf_counter()
        RS.save_checkpoint(sm.state.checkpoint(), path,
                           meta={"stream_version": sm.stream_version})
        blob, meta = RS.load_checkpoint(path)
        ck_ms = (time.perf_counter() - t0) * 1e3
    check(meta == {"stream_version": 10}, f"{tag}: checkpoint meta {meta}")
    restored = StreamingMiner(bib.sizes, device="cuda")
    restored.state = RS.RunStore.restore(blob)
    back, back_ms = counted(f"{tag} snapshot after restore",
                            restored.snapshot, expect())
    equal_leaves(back, snap, f"{tag} restored vs uninterrupted")
    log(f"{tag}: snapshot ms after each step {[round(x, 3) for x in snap_ms]}"
        f"; warm (min of 3) incremental {snap_warm:.3f}, full_remine "
        f"{full_warm:.3f}, windowed (budget {step}, {windows} windows) "
        f"{win_warm:.3f}; checkpoint save + load {ck_ms:.3f} ms, "
        f"snapshot after restore {back_ms:.3f} ms; every leaf equal to the "
        f"incremental snapshot, and the per-tuple leaves to a batch mine of "
        f"the {survivors.shape[0]} survivors")
    log(f"phase 10: {time.perf_counter() - t_phase:.1f} s")
    return runs


#: Ranks of phase 11c's gloo group on the one card.
GLOO_RANKS = 4


def mining_launches(sizes, with_values=False, value_slots=None, extra=0,
                    sorted_stage1=True, windows=1):
    """Mining-kernel launches of one run: per window a segment sweep per
    mode and one Stage-3 sort (a histogram, 8 fused passes); a Stage 1
    that sorts on the card adds a histogram per mode and one fused pass
    per 8 bits of its keys (``extra`` bits more: the shuffle's owners
    sort with the validity flag as a top bit)."""
    from repro_torch.core import keys as K
    n = len(sizes)
    bits = K.plan_context_keys(sizes, with_values, value_slots)[0].total_bits
    passes = math.ceil((bits + extra) / 8) if sorted_stage1 else 0
    return {"segment_reduce": n * windows,
            "radix_histogram": windows + (n if sorted_stage1 else 0),
            "radix_rank": 8 * windows + n * passes}


def phase11c_rank(rank: int, tmp: str) -> None:
    """One of phase 11c's gloo ranks on ``cuda:0``: BibSonomy prime and the
    MovieLens-1M shape NOAC under ``shuffle``; writes its report, and rank 0
    its checks against the in-core miners, to ``tmp/rank<r>.json``."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import (BatchMiner, DistributedMiner, NOACMiner,
                                  pad_tuples, pad_values)
    from repro_torch.core import keys as K
    from repro_torch.data import synthetic as S
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    # the ranks share the host's cores (host work: gloo, numpy, launches)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // GLOO_RANKS))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg11c",
                            rank=rank, world_size=GLOO_RANKS,
                            timeout=datetime.timedelta(seconds=300))
    report = {"rank": rank, "runs": {}}
    try:
        mesh = make_mesh((GLOO_RANKS,), ("data",), device="cuda")
        report["staged"] = mesh.staged
        bib = S.bibsonomy_like()
        ml = S.movielens_like(n_tuples=ML_T).deduplicated()
        for tag, ctx, kw in (("bibsonomy prime", bib, {}),
                             ("movielens noac", ml, {"delta": 1.0})):
            tuples = pad_tuples(ctx.tuples, GLOO_RANKS)
            values = (None if ctx.values is None
                      else pad_values(ctx.values, GLOO_RANKS))
            args = (tuples,) if values is None else (tuples, values)
            miner = DistributedMiner(ctx.sizes, mesh, strategy="shuffle",
                                     **kw)
            miner(*args).keep.cpu()                       # cold
            miner.capacity_factor = 2.0
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = miner(*args)
            res.keep.cpu()
            ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            times = [ms]
            for _ in range(2):
                miner.capacity_factor = 2.0
                dist.barrier()
                t0 = time.perf_counter()
                miner(*args).keep.cpu()
                times.append((time.perf_counter() - t0) * 1e3)
            vslots = (None if values is None
                      else K.value_domain_host(values).shape[0])
            runs = int(round(math.log2(miner.capacity_factor / 2.0))) + 1
            want = mining_launches(ctx.sizes, values is not None, vslots,
                                   extra=1)
            want = {k: v * runs for k, v in want.items()}
            got = res.gather()
            entry = {
                "T": int(tuples.shape[0]), "counts": counts,
                "expected": want, "warm_ms": times,
                "capacity_factor": miner.capacity_factor,
                "hash_fallback": [bool(f) for f in miner.hash_fallback],
                "overflow": int(res.overflow)}
            if rank == 0:
                cls = NOACMiner if values is not None else BatchMiner
                inc = cls(ctx.sizes, device="cuda", **kw)(*args)
                entry["equal"] = {
                    name: bool(torch.equal(getattr(got, name),
                                           getattr(inc, name)))
                    for name in ("sig_lo", "sig_hi", "gen_count", "volume",
                                 "density", "is_unique", "keep",
                                 "cardinalities")}

                def uniq(r):
                    u = r.is_unique.cpu().numpy()
                    return set(zip(r.sig_lo.cpu().numpy()[u].tolist(),
                                   r.sig_hi.cpu().numpy()[u].tolist()))
                entry["unique_sets_equal"] = uniq(got) == uniq(inc)
                entry["n_clusters"] = [int(got.n_clusters),
                                       int(inc.is_unique.sum())]
                entry["kept"] = [int(got.keep.sum()), int(inc.keep.sum())]
            report["runs"][tag] = entry
    finally:
        dist.destroy_process_group()
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(report, f)


def phase11(bib, ml, prime_ms: float, noac_ms: float) -> dict:
    """Phase 11: distributed mining (``core.distributed``) on the card.

    (a) An NCCL group of one rank: BibSonomy prime and the MovieLens-1M
    shape NOAC (delta 1) under ``replicate`` and ``shuffle``, every
    ``DistributedResult`` leaf equal to the in-core result, overflow 0,
    launches as the key plans give them (the owners sort total_bits + 1
    bits).  (b) BibSonomy ingested in 8 chunks into the per-shard stores:
    ``snapshot()``, ``snapshot(full_remine=True)``, ``serving_snapshot()``
    and a windowed ``serving_snapshot()`` at ceil(T/8), each one's kept
    signatures and per-tuple leaves equal to the in-core ones.  (c) Four
    gloo ranks on the one card (NCCL takes one rank a card) under
    ``shuffle``, their collectives staged through host memory: rank 0's
    gathered result against the in-core miner.  Returns {run: launch
    counts}."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.core import BatchMiner, DistributedMiner, NOACMiner
    from repro_torch.core import keys as K
    from repro_torch.core import pipeline as P
    from repro_torch.core import radix as RX
    from repro_torch.core.distributed import LEAVES
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh

    mining = ops.PATH_KERNELS["mining"]
    runs = {}

    def counted(label, fn, want):
        """Run ``fn`` once with the counts at 0 and check them against
        ``want`` (no other kernel, no plain version on the card)."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        res.keep.cpu()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        path = {k: counts[k] for k in mining}
        check(path == want, f"{label}: launches {path} != {want}")
        check(all(n == 0 for k, n in counts.items() if k not in mining),
              f"{label}: a kernel of another path was launched: {counts}")
        runs[label] = counts
        return res, ms

    def warm(label, fn, first_ms, n_t, incore_ms=None):
        """Two more warm runs (min of 3 with the counted one) and one under
        the profiler for the device busy share."""
        times = [first_ms]
        for _ in range(2):
            t0 = time.perf_counter()
            fn().keep.cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        busy, _, _, complete = device_ms(lambda: fn().keep.cpu(), iters=1,
                                         warm=False)
        best = min(times)
        share = ("busy not measured" if busy is None or not complete
                 else f"device busy {busy:.3f} ms (idle share "
                 f"{1 - busy / best:.3f})")
        log(f"{label}: warm ms {[round(t, 3) for t in times]} (min "
            f"{best:.3f}; {n_t / (best / 1e3):.0f} tuples/s); {share}"
            + ("" if incore_ms is None
               else f"; in-core {incore_ms:.3f} ms (phases 3-4)"))
        return best

    def rows_equal(a, b, what, rows, names):
        for name in names:
            x, y = getattr(a, name), getattr(b, name)
            x = x[..., :rows] if x.dim() else x
            y = y[..., :rows] if y.dim() else y
            check(x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()),
                  f"{what}: leaf {name} differs")

    t_phase = time.perf_counter()
    bib_inc = BatchMiner(bib.sizes, device="cuda")(bib.tuples)
    ml_inc = NOACMiner(ml.sizes, delta=1.0, device="cuda")(ml.tuples,
                                                          ml.values)
    ml_slots = K.value_domain_host(ml.values).shape[0]
    cases = (("bibsonomy prime", bib, (bib.tuples,), {}, bib_inc, prime_ms,
              (False, None)),
             ("movielens noac", ml, (ml.tuples, ml.values), {"delta": 1.0},
              ml_inc, noac_ms, (True, ml_slots)))
    with tempfile.TemporaryDirectory() as tmp:
        # (a) and (b): an NCCL group of one rank
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg11a",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_local_mesh(device="cuda")
            check(mesh.group is not None and not mesh.staged
                  and dist.get_backend(mesh.group) == "nccl",
                  f"phase 11a mesh {mesh}")
            for tag, ctx, args, kw, inc, inc_ms, vkey in cases:
                for strategy in ("replicate", "shuffle"):
                    label = f"phase 11a {tag} {strategy}"
                    miner = DistributedMiner(ctx.sizes, mesh,
                                             strategy=strategy, **kw)
                    miner(*args).keep.cpu()               # cold
                    want = mining_launches(
                        ctx.sizes, *vkey,
                        extra=1 if strategy == "shuffle" else 0)
                    res, ms = counted(label, lambda: miner(*args), want)
                    check(int(res.overflow) == 0 and
                          miner.capacity_factor == 2.0,
                          f"{label}: overflow {int(res.overflow)}")
                    rows_equal(res, inc, f"{label} vs in-core",
                               ctx.num_tuples, LEAVES[:8])
                    check(int(res.n_clusters) == int(inc.is_unique.sum()),
                          f"{label}: n_clusters {int(res.n_clusters)}")
                    log(f"{label}: launches {want}; every leaf equal to "
                        f"the in-core result; n_clusters "
                        f"{int(res.n_clusters)}, kept {int(res.keep.sum())}"
                        + ("; owners by mode: " + ", ".join(
                            "hash" if bool(f) else "range"
                            for f in miner.hash_fallback)
                           if strategy == "shuffle" else ""))
                    warm(label, lambda: miner(*args), ms, ctx.num_tuples,
                         inc_ms)

            # (b) the incremental path over the BibSonomy table
            tag = "phase 11b incremental bibsonomy"
            t = bib.num_tuples
            step = math.ceil(t / 8)
            miner = DistributedMiner(bib.sizes, mesh)
            t0 = time.perf_counter()
            for lo in range(0, t, step):
                miner.ingest(bib.tuples[lo:lo + step])
            ingest_ms = (time.perf_counter() - t0) * 1e3
            kept = P.kept_sig_words(bib_inc)
            per_tuple = LEAVES[:8]
            perms_run = mining_launches(bib.sizes, sorted_stage1=False)
            snaps = {}
            for what, fn, want in (
                    ("snapshot", miner.snapshot, perms_run),
                    ("snapshot full_remine",
                     lambda: miner.snapshot(full_remine=True),
                     mining_launches(bib.sizes)),
                    ("serving_snapshot", miner.serving_snapshot, perms_run)):
                res, ms = counted(f"{tag} {what}", fn, want)
                rows_equal(res, bib_inc, f"{tag} {what} vs in-core", t,
                           per_tuple)
                check(np.array_equal(P.kept_sig_words(res), kept),
                      f"{tag} {what}: kept signatures differ")
                snaps[what] = (ms, warm(f"{tag} {what}", fn, ms, t))
            miner.window_budget = step
            cap = len(res.keep)
            windows = RX.plan_windows(cap, step).n_windows
            what = f"serving_snapshot windowed (budget {step})"
            res, ms = counted(f"{tag} {what}", miner.serving_snapshot,
                              mining_launches(bib.sizes, sorted_stage1=False,
                                              windows=windows))
            rows_equal(res, bib_inc, f"{tag} {what} vs in-core", t,
                       per_tuple)
            check(np.array_equal(P.kept_sig_words(res), kept),
                  f"{tag} {what}: kept signatures differ")
            snaps[what] = (ms, warm(f"{tag} {what}", miner.serving_snapshot,
                                    ms, t))
            log(f"{tag}: ingest of {t} rows in 8 chunks {ingest_ms:.3f} ms; "
                "first / warm ms " + "; ".join(
                    f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in snaps.items())
                + f" ({windows} windows of a {cap}-row snapshot); kept "
                f"signatures and per-tuple leaves equal to the in-core ones; "
                f"stream_stats {miner.stream_stats}")
        finally:
            dist.destroy_process_group()

        # (c) four gloo ranks on the one card
        t0 = time.perf_counter()
        mp.start_processes(phase11c_rank, args=(tmp,), nprocs=GLOO_RANKS,
                           start_method="spawn")
        wall = time.perf_counter() - t0
        reports = []
        for r in range(GLOO_RANKS):
            with open(f"{tmp}/rank{r}.json") as f:
                reports.append(json.load(f))
    check(all(r["staged"] for r in reports),
          "phase 11c: the gloo mesh on the card did not stage")
    log(f"phase 11c: {GLOO_RANKS} gloo ranks on cuda:0 in {wall:.1f} s "
        "wall (start-up included); collectives staged through host "
        "memory (gloo group, CUDA tensors)")
    for tag, entry in reports[0]["runs"].items():
        label = f"phase 11c {tag} shuffle {GLOO_RANKS} ranks"
        for r in reports:
            e = r["runs"][tag]
            path = {k: e["counts"][k] for k in mining}
            check(path == e["expected"], f"{label} rank {r['rank']}: "
                  f"launches {path} != {e['expected']}")
            check(e["overflow"] == 0, f"{label}: overflow {e['overflow']}")
            runs[f"{label} rank {r['rank']}"] = e["counts"]
        for name in ("sig_lo", "sig_hi", "gen_count", "volume", "density"):
            check(entry["equal"][name], f"{label}: leaf {name} differs from "
                  "the in-core result")
        check(entry["unique_sets_equal"],
              f"{label}: unique signature sets differ")
        check(entry["n_clusters"][0] == entry["n_clusters"][1],
              f"{label}: n_clusters {entry['n_clusters']}")
        check(entry["kept"][0] == entry["kept"][1],
              f"{label}: kept {entry['kept']}")
        log(f"{label}: T={entry['T']}; owners by mode: " + ", ".join(
            "hash" if f else "range" for f in entry["hash_fallback"])
            + f"; final capacity_factor {entry['capacity_factor']}; "
            f"launches per rank {entry['expected']}; warm ms (rank 0) "
            f"{[round(x, 3) for x in entry['warm_ms']]} (min "
            f"{min(entry['warm_ms']):.3f}); sig_lo, sig_hi, gen_count, "
            "volume, density equal to the in-core result, unique sets, "
            f"n_clusters {entry['n_clusters'][0]} and kept "
            f"{entry['kept'][0]} agree; every leaf equal: "
            f"{all(entry['equal'].values())}")
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return runs


#: Rows of BibSonomy's table that phase 12 serves: its first thirty-
#: second, ceil(T/32).  The cut is the run's time limit.  The service's
#: index is host numpy over every component member (the JAX package's
#: design), and on this generator the members grow as about T^1.6: 9.7M,
#: 28.6M and 83.8M at the first 102,025, 204,050 and 408,100 rows, whose
#: full builds took 16.5, 52.3 and 179.1 s on the card's host
#: (``scripts/torch_service_swap.py`` on an H100 80GB HBM3).  The
#: phase builds an index about 35 times.
SERVICE_ROWS = 25_507
#: Rounds of phase 12's upserts, and the share of the rows each upserts.
SERVICE_ROUNDS = 8
SERVICE_UPSERT = 1000          # one row in this many: 0.1%
#: Entities of each phase-12 batched query, and hits per entity.
QUERY_BATCH = 4096
QUERY_K = 10


def phase12(bib) -> dict:
    """Phase 12: the cluster service (``serve``) on the card over the
    first :data:`SERVICE_ROWS` rows of BibSonomy's table (the mode sizes
    and the generator of the full context; the cut is explained there).

    (a) ``TriclusterService(backend="streaming", delta_index=True)`` with
    an enabled ``obs`` hub: the rows ingested in 8 chunks, ``start()``,
    then 8 rounds of 0.1% upserts, each with a ``refresh()``.  At every
    published version the delta index equals ``ClusterIndex.from_result``
    of the same result, array for array, and ``query_batch`` of 4,096
    entities (k = 10) equals ``BatchQuerier`` over that full-built index;
    at the last version the index equals one built from ``full_remine``
    on the card and one from an in-core ``BatchMiner`` on the card over
    the same rows (its ``mine_chunked`` and ``mine_windowed`` too, which
    fill the stage histograms).  (b) The same write stream through
    ``backend="distributed"`` on an NCCL group of one rank: the kept
    signature words and top-k hits at every version equal (a)'s.  (c) The
    CLI's ``--top-k 5`` and ``--query-entity E --query-mode 0`` on the
    card and on the CPU: rc 0 and the same ranked lines.  (d) A service
    with ``recover_dir``, writes, ``stop()``; a successor restored from
    the checkpoint and the WAL publishes the same signatures and scores.
    Returns {run: launch counts}."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import BatchMiner
    from repro_torch.kernels import ops
    from repro_torch.launch import tricluster
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.obs import Obs
    from repro_torch.serve import (BatchQuerier, ClusterIndex,
                                   TriclusterService)
    from repro_torch.serve.clusters import INDEX_LEAVES

    mining = ops.PATH_KERNELS["mining"]
    runs = {}
    t_phase = time.perf_counter()
    table = bib.tuples[:SERVICE_ROWS]
    t = table.shape[0]
    step = math.ceil(t / 8)
    rng = np.random.default_rng(2027)
    # each round upserts 0.1% of the rows with a new tag (mode 2): mostly
    # tuples the table does not hold, so clusters change at every swap
    picks = []
    for _ in range(SERVICE_ROUNDS):
        rows = table[rng.choice(t, t // SERVICE_UPSERT,
                                replace=False)].copy()
        rows[:, 2] = rng.integers(0, bib.sizes[2], rows.shape[0])
        picks.append(rows)
    ents = rng.integers(0, max(bib.sizes), QUERY_BATCH)
    quiet = dict(refresh_interval=3600.0, dirty_threshold=10**9)
    per_snapshot = {"segment_reduce": 3, "radix_histogram": 1,
                    "radix_rank": 8}

    def index_equal(a, b, what):
        check(len(a) == len(b), f"{what}: {len(a)} vs {len(b)} clusters")
        for name in ("packed_sigs", "sig_lo", "sig_hi", "density",
                     "gen_count", "volume", "any_pairs"):
            x, y = getattr(a, name), getattr(b, name)
            check(x.dtype == y.dtype and np.array_equal(x, y),
                  f"{what}: {name} differs")
        for name in ("mode_pairs", "comp_ents", "comp_bounds"):
            for k, (x, y) in enumerate(zip(getattr(a, name),
                                           getattr(b, name))):
                check(x.dtype == y.dtype and np.array_equal(x, y),
                      f"{what}: {name}[{k}] differs")

    def hits(hl):
        return [(v.signature, s) for v, s in hl]

    def counted_path(label, counts, want):
        path = {k: counts[k] for k in mining}
        check(all(n > 0 for n in path.values()),
              f"{label}: a kernel of the path was not launched: {counts}")
        check(path == want, f"{label}: launches {path} != {want}")
        check(all(n == 0 for k, n in counts.items() if k not in mining),
              f"{label}: a kernel of another path was launched: {counts}")
        runs[label] = counts

    def drive(svc, label, check_each=None):
        """The write stream through ``svc``, counts at 0 before it and
        read after it; {version: (packed sigs, global top-k)}."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for lo in range(0, t, step):
            svc.add(table[lo:lo + step])
        add_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        svc.start()
        start_ms = (time.perf_counter() - t0) * 1e3
        seen, upsert_ms, refresh_ms, dirty = {}, [], [], []
        for r in range(SERVICE_ROUNDS + 1):
            snap = svc.snapshot()
            counts = ops.launch_counts()     # the checks launch nothing
            seen[snap.version] = (snap.index.packed_sigs,
                                  hits(svc.query(k=QUERY_K).hits))
            dirty.append(svc.dirty_clusters)
            t0 = time.perf_counter()
            if check_each is not None:
                check_each(snap)
            check(ops.launch_counts() == counts,
                  f"{label}: a check launched a kernel")
            log(f"{label}: v{snap.version}, {len(snap.index)} clusters, "
                f"{dirty[-1]} changed; swap "
                f"{refresh_ms[-1] if refresh_ms else start_ms:.3f} ms; "
                f"checks {(time.perf_counter() - t0) * 1e3:.3f} ms")
            if r == SERVICE_ROUNDS:
                break
            t0 = time.perf_counter()
            svc.upsert(picks[r])
            upsert_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            svc.refresh()
            refresh_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        check(min(dirty[1:]) > 0, f"{label}: a swap changed no cluster "
              f"({dirty})")
        counted_path(label, ops.launch_counts(),
                     {k: v * (SERVICE_ROUNDS + 1)
                      for k, v in per_snapshot.items()})
        log(f"{label}: {t} rows added in 8 chunks {add_ms:.3f} ms; start() "
            f"(first swap, full index) {start_ms:.3f} ms; upserts of "
            f"{t // SERVICE_UPSERT} rows ms {[round(x, 3) for x in upsert_ms]}"
            f"; refresh() ms {[round(x, 3) for x in refresh_ms]}; launches "
            f"{per_snapshot} x {SERVICE_ROUNDS + 1} swaps; versions "
            f"{sorted(seen)}; clusters changed at each swap {dirty}; stats "
            + json.dumps(
                {k: v for k, v in svc.stats().items()
                 if k in ("publishes", "delta_builds", "full_builds",
                          "clusters", "dirty_clusters", "stream_version",
                          "scrubs", "scrub_errors", "mine_errors")}))
        return seen

    # (a) the streaming service
    tag = "phase 12a streaming service bibsonomy/32"
    obs = Obs.create(service="phase12")
    svc = TriclusterService(bib.sizes, backend="streaming", obs=obs,
                            delta_index=True, device="cuda", **quiet)
    check(svc.device.type == "cuda" and svc.device.index is not None,
          f"{tag}: service device {svc.device}")
    query_ms, build_full_ms = [], []

    def check_each(snap):
        t0 = time.perf_counter()
        full = ClusterIndex.from_result(snap.result)
        build_full_ms.append((time.perf_counter() - t0) * 1e3)
        index_equal(snap.index, full, f"{tag} v{snap.version} delta vs "
                    "full")
        t0 = time.perf_counter()
        got = svc.query_batch(ents, k=QUERY_K).hits
        query_ms.append((time.perf_counter() - t0) * 1e3)
        want = BatchQuerier(full, svc.policy, snap.ages).topk_batch(
            ents, None, QUERY_K)
        check([hits(h) for h in got] == [hits(h) for h in want],
              f"{tag} v{snap.version}: query_batch differs from "
              "BatchQuerier over the full-built index")
    seen_a = drive(svc, tag, check_each)
    snap = svc.snapshot()
    n_hits = sum(len(h) for h in svc.query_batch(ents, k=QUERY_K).hits)
    svc.stop()
    with svc._wlock:
        remine = svc.miner.snapshot(full_remine=True)
        survivors = svc.miner.state.table()[0].copy()
    index_equal(snap.index, ClusterIndex.from_result(remine),
                f"{tag} last version vs full_remine")
    pipe = BatchMiner(bib.sizes, device="cuda")
    pipe.obs = obs
    for what, res in (
            ("in-core BatchMiner", pipe(survivors)),
            ("mine_chunked", pipe.mine_chunked(survivors,
                                               chunk_budget=step)),
            ("mine_windowed", pipe.mine_windowed(survivors,
                                                 window_budget=step))):
        index_equal(snap.index, ClusterIndex.from_result(res),
                    f"{tag} last version vs {what} of the "
                    f"{survivors.shape[0]} live rows")
    m = obs.metrics
    stages = {}
    for st in ("mine_monolithic", "stage1_sort", "device_mine",
               "stage1_scan", "stage2_mix", "stage3_sort"):
        h = m.histogram("pipeline_stage_ms", stage=st)
        check(h.count > 0, f"{tag}: pipeline_stage_ms{{stage={st}}} empty")
        stages[st] = round(h.sum / h.count, 3)
    windows = {st: m.histogram("pipeline_window_ms", stage=st).count
               for st in ("stage1_scan", "stage2_mix", "stage3_sort")}
    check(all(windows.values()), f"{tag}: window histograms {windows}")

    def q(name, **labels):
        h = m.histogram(name, **labels)
        s = h.snapshot()
        return (f"n {s['count']} p50 {h.quantile(0.5):.3f} p99 "
                f"{h.quantile(0.99):.3f} min {s['min']:.3f} max "
                f"{s['max']:.3f}")
    swaps = [sp["attrs"] for sp in obs.tracer.spans()
             if sp["name"] == "service.swap"]
    check(len(swaps) == SERVICE_ROUNDS + 1, f"{tag}: {len(swaps)} swaps")
    log(f"{tag}: service_mine_ms {q('service_mine_ms')}; "
        f"service_index_build_ms{{kind=full}} "
        f"{q('service_index_build_ms', kind='full')}; "
        f"service_index_build_ms{{kind=delta}} "
        f"{q('service_index_build_ms', kind='delta')}; service_swap_ms "
        f"{q('service_swap_ms')}")
    log(f"{tag}: readback of the {len(INDEX_LEAVES)} index leaves per swap: "
        f"{swaps[-1]['readback_bytes']} bytes, ms "
        f"{[round(a['readback_ms'], 3) for a in swaps]}; mine ms (readback "
        f"included) {[round(a['mine_ms'], 3) for a in swaps]}")
    log(f"{tag}: query_batch of {QUERY_BATCH} entities (k {QUERY_K}) ms "
        f"{[round(x, 3) for x in query_ms]} ({n_hits} hits at the last "
        f"version); full from_result build ms "
        f"{[round(x, 3) for x in build_full_ms]}; {len(snap.index)} clusters"
        f" at v{snap.version}; every delta index equal to the full build, "
        f"every batch equal to BatchQuerier over it; the last index equal "
        f"to full_remine's, the in-core miner's, mine_chunked's and "
        f"mine_windowed's")
    log(f"{tag}: pipeline_stage_ms mean by stage {stages}; "
        f"pipeline_window_ms counts {windows}; seam carries "
        f"{m.counter('pipeline_seam_carries_total').value}; window peak "
        "bytes " + json.dumps({r['labels']['stage']: r['value'] for r in
                                m.to_dict()['pipeline_window_peak_bytes']
                                ['series']}))

    # (b) the distributed service at one NCCL rank
    tag = "phase 12b distributed service bibsonomy/32"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg12",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_local_mesh(device="cuda")
            check(mesh.group is not None and not mesh.staged,
                  f"{tag}: mesh {mesh}")
            dsvc = TriclusterService(bib.sizes, backend="distributed",
                                     mesh=mesh, device="cuda", **quiet)
            seen_b = drive(dsvc, tag)
            dsvc.stop()
        finally:
            dist.destroy_process_group()
    check(sorted(seen_b) == sorted(seen_a), f"{tag}: versions")
    for v, (sigs, top) in seen_a.items():
        check(np.array_equal(seen_b[v][0], sigs),
              f"{tag} v{v}: kept signature words differ from 12a's")
        check(seen_b[v][1] == top, f"{tag} v{v}: top-k hits differ")
    log(f"{tag}: kept signature words and top-{QUERY_K} hits equal to "
        f"12a's at every version ({len(seen_a)} versions)")

    # (c) the CLI's serving flags, on the card and on the CPU
    outs = {}
    for device in ("cuda", "cpu"):
        for flags in (("--top-k", "5"),
                      ("--query-entity", "207", "--query-mode", "0")):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = tricluster.main(["--dataset", "imdb", "--device",
                                      device, "--print-top", "0", *flags])
            check(rc == 0, f"phase 12c CLI {flags} on {device}: rc={rc}")
            lines = buf.getvalue().splitlines()
            first = [i for i, ln in enumerate(lines) if "top-" in ln]
            check(len(first) == 1, f"phase 12c CLI {flags}: no ranking")
            outs[(device, flags)] = lines[first[0]:]
    for flags in {f for _, f in outs}:
        check(outs[("cuda", flags)] == outs[("cpu", flags)],
              f"phase 12c CLI {flags}: the card's ranked lines differ "
              "from the CPU's")
        check(sum("score=" in ln for ln in outs[("cuda", flags)]) >= 1,
              f"phase 12c CLI {flags}: no ranked line")
    print("\n".join(outs[("cuda", ("--query-entity", "207",
                                   "--query-mode", "0"))]), flush=True)
    log("phase 12c CLI: --top-k 5 and --query-entity 207 --query-mode 0 "
        "rc 0 on the card and on the CPU, the same ranked lines")

    # (d) recovery from the checkpoint and the WAL
    tag = "phase 12d recovery bibsonomy/32"
    with tempfile.TemporaryDirectory() as rec:
        kw = dict(recover_dir=rec, checkpoint_every=8, device="cuda",
                  **quiet)
        svc = TriclusterService(bib.sizes, **kw)
        t0 = time.perf_counter()
        for lo in range(0, t, step):
            svc.add(table[lo:lo + step])
        svc.start()                          # v1: checkpoint at cadence
        for r in range(2):
            svc.upsert(picks[r])             # in the WAL only
        last = svc.refresh()
        svc.stop()
        write_s = time.perf_counter() - t0
        check(svc.stats()["checkpoints"] == 1,
              f"{tag}: checkpoints {svc.stats()['checkpoints']}")
        t0 = time.perf_counter()
        succ = TriclusterService(bib.sizes, **kw)
        restore_ms = (time.perf_counter() - t0) * 1e3
        r = succ.recovered
        check(r.get("checkpoint_generation") == "current"
              and r.get("replayed_ops") == 2
              and succ.stream_version == svc.stream_version,
              f"{tag}: recovered {r}")
        t0 = time.perf_counter()
        succ.start()
        first_ms = (time.perf_counter() - t0) * 1e3
        got = succ.snapshot()
        check(got.version == last.version,
              f"{tag}: version {got.version} != {last.version}")
        check(np.array_equal(got.index.packed_sigs, last.index.packed_sigs)
              and np.array_equal(got.querier.scores, last.querier.scores),
              f"{tag}: signatures or scores differ from the predecessor")
        check(hits(succ.query(k=QUERY_K).hits)
              == hits(svc.query(k=QUERY_K).hits), f"{tag}: top-k differs")
        succ.stop()
    log(f"{tag}: predecessor wrote 8 chunks + 2 upserts with a checkpoint "
        f"at v1 ({write_s:.1f} s with its swaps); successor restored "
        f"{r} in {restore_ms:.3f} ms and published v{got.version} in "
        f"{first_ms:.3f} ms with the same {len(got.index)} signatures, "
        "scores and top-k")
    log(f"phase 12: {time.perf_counter() - t_phase:.1f} s")
    return runs


#: The serving plane of phase 13b-c: BibSonomy-shaped rows (the
#: generator at this table size) behind this many writers, each with
#: this many shared-memory replicas.  ``core.runs.shard_of_rows`` splits
#: the rows by the top digit of the mode-0 identity key, whose leading
#: lane is the tag; BibSonomy's tags are power-law, so the split is
#: skewed (51,008 / 6 rows here; the plane prints it) and one writer
#: holds nearly every row.  Twice phase 12's rows, cut by the run's time
#: limit: that writer's index build grows as about N^2 (phase 12).
PLANE_ROWS = 51_014
PLANE_SHARDS = 2
PLANE_REPLICAS = 2
#: Entities of phase 13b's batched query through the router.
PLANE_BATCH = 256
#: Scalar queries and batches phase 13a times over HTTP.
HTTP_SCALARS = 200
HTTP_BATCHES = 10
SHM = "/dev/shm"


def shm_free() -> int:
    st = os.statvfs(SHM)
    return st.f_bavail * st.f_frsize


def shm_segments(prefix: str) -> list:
    return sorted(e for e in os.listdir(SHM) if e.startswith(prefix))


def device_fds(pid: int) -> list:
    """The NVIDIA device files process ``pid`` holds open."""
    out = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def urllib_get(url: str) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def compute_apps() -> list:
    """PIDs with a CUDA context on the card, as ``nvidia-smi`` lists
    them."""
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi compute apps: {smi.stderr}")
    return sorted(int(x) for x in smi.stdout.split())


def phase13(bib) -> dict:
    """Phase 13: the multi-process serving plane (``serve.{shm,protocol,
    router,supervise}``, ``launch.cluster_serve``) with writers mining on
    the card.

    (a) One process: a card-backed ``TriclusterService(backend=
    "streaming")`` over BibSonomy's first :data:`SERVICE_ROWS` rows that
    publishes to shared memory (``ShmPublisher``), served by
    ``make_server`` on a thread, and a ``ReplicaService`` of its segments
    served by a second ``make_server``.  The smoke client's sequence
    against both: scalar, batch of 4,096, top-k with components,
    signature round-trip, upsert, refresh, ``at_least_version``; at equal
    versions the writer's HTTP answers, the replica's and ``svc.query``/
    ``svc.query_batch`` are equal hit for hit; launches a swap as in
    phase 12; publish ms, bundle bytes, the replica's attach ms and HTTP
    p50/p99.  (b) The plane: ``python -m repro_torch.launch.cluster_serve
    --dataset bibsonomy --n-tuples PLANE_ROWS --shards 2 --replicas 2
    --device cuda --metrics``; ``nvidia-smi`` lists a CUDA context for
    this process and the writers only; the router's top-k and a batch of
    :data:`PLANE_BATCH` entities equal in-process card-backed services
    of each shard's rows merged with ``router._merge_hits``; each
    writer's launches (its ``/metrics``) are the swap's times its
    publishes; then ``--smoke-client`` passes.  (c) The same plane with
    ``FaultPlan.kill_writer(0, at_stream_version=5)`` (the first write
    after the 4 preload chunks): the supervisor restarts shard-0, its
    writer recovers the stream from checkpoint and WAL on the card, the
    router's ``/metrics`` counts one restart, and an
    ``at_least_version`` read returns the written row's cluster.  After
    each plane no segment of it is left in ``/dev/shm``.
    Returns {run: launch counts}."""
    import tempfile
    import threading

    import numpy as np
    import torch
    from repro_torch.core import keys as K
    from repro_torch.core import runs as RS
    from repro_torch.kernels import ops
    from repro_torch.launch.tricluster import load_dataset
    from repro_torch.serve import (ClusterClient, ReplicaService,
                                   ShmPublisher, TriclusterService,
                                   make_server)
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.protocol import hit_doc
    from repro_torch.serve.router import _merge_hits

    mining = ops.PATH_KERNELS["mining"]
    per_swap = {"segment_reduce": 3, "radix_histogram": 1, "radix_rank": 8}
    runs = {}
    t_phase = time.perf_counter()
    quiet = dict(refresh_interval=3600.0, dirty_threshold=10**9)
    log(f"phase 13: {SHM} free {shm_free()} bytes")

    def swap_launches(label, counts, swaps):
        """``counts`` are ``swaps`` times a swap's launches, all on the
        mining path."""
        want = {k: v * swaps for k, v in per_swap.items()}
        path = {k: counts[k] for k in mining}
        check(all(n > 0 for n in path.values()),
              f"{label}: a kernel of the path was not launched: {counts}")
        check(path == want, f"{label}: launches {path} != {want} "
              f"({swaps} swaps)")
        check(all(n == 0 for k, n in counts.items() if k not in mining),
              f"{label}: a kernel of another path was launched: {counts}")
        return counts

    def docs(hits, comps=False):
        return [hit_doc(v, s, comps) for v, s in hits]

    def fits(bundle_bytes, what):
        free = shm_free()
        log(f"{what}: bundle {bundle_bytes} bytes, {SHM} free {free} "
            "bytes")
        check(bundle_bytes <= free, f"{what}: a bundle of {bundle_bytes} "
              f"bytes does not fit in {SHM}'s {free} free bytes (a writer "
              "holds two during a swap)")

    def pct(xs):
        return (f"p50 {np.percentile(xs, 50):.3f} p99 "
                f"{np.percentile(xs, 99):.3f} ms")

    # (a) one process: writer and replica behind their own endpoints
    tag = "phase 13a writer and replica bibsonomy/32"
    table = bib.tuples[:SERVICE_ROWS]
    t = table.shape[0]
    step = math.ceil(t / 8)
    rng = np.random.default_rng(2028)
    ents = rng.integers(0, max(bib.sizes), QUERY_BATCH).tolist()
    fresh = table[rng.choice(t, t // SERVICE_UPSERT, replace=False)].copy()
    fresh[:, 2] = rng.integers(0, bib.sizes[2], fresh.shape[0])
    prefix = f"p13a{os.getpid()}"
    pub = ShmPublisher(prefix)
    svc = TriclusterService(bib.sizes, backend="streaming", device="cuda",
                            publisher=pub, **quiet)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for lo in range(0, t, step):
        svc.add(table[lo:lo + step])
    svc.start()
    fits(pub._data.size, f"{tag} v1")
    check(svc.stats()["publish_errors"] == 0,
          f"{tag}: publish failed: {svc.stats().get('last_publish_error')}")
    rep = ReplicaService(prefix, scrub_interval=0).start()
    servers = [make_server(s, port=0) for s in (svc, rep)]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    wcl, rcl = (ClusterClient(f"http://127.0.0.1:{s.port}", timeout=120)
                for s in servers)

    def same_answers(version):
        """Writer HTTP, replica HTTP and the service in-process agree."""
        rep.snapshot(at_least_version=version, timeout=60)
        check(svc.version == rep.version == version,
              f"{tag}: versions {svc.version}/{rep.version} != {version}")
        for e, mode in ((ents[0], 0), (ents[1], 1), (ents[2], None)):
            want = docs(svc.query(entity=e, mode=mode, k=QUERY_K).hits)
            for cl in (wcl, rcl):
                got = cl.query(entity=e, mode=mode, k=QUERY_K)
                check(got["version"] == version and got["hits"] == want,
                      f"{tag} v{version}: scalar query of {e} differs")
        want = [docs(h) for h in svc.query_batch(ents, k=QUERY_K).hits]
        for cl in (wcl, rcl):
            got = cl.query_batch(ents, k=QUERY_K)
            check(got["version"] == version and got["hits"] == want,
                  f"{tag} v{version}: batch of {len(ents)} differs")
        want = docs(svc.query(k=QUERY_K).hits, True)
        check(want, f"{tag} v{version}: empty top-k")
        for cl in (wcl, rcl):
            top = cl.query(k=QUERY_K, include_components=True)
            check(top["hits"] == want, f"{tag} v{version}: top-k differs")
            sig = top["hits"][0]["signature"]
            by_sig = cl.query(signature=sig, include_components=True)
            check(by_sig["hits"] == want[:1],
                  f"{tag} v{version}: signature round-trip differs")
        return sum(len(h) for h in want)

    try:
        n_hits = same_answers(1)
        up = wcl.upsert(fresh.tolist())
        check(up["stream_version"] == 9, f"{tag}: upsert {up}")
        ref = wcl.refresh()
        check(ref["version"] == 2, f"{tag}: refresh {ref}")
        got = rcl.query(entity=int(fresh[0, 0]), mode=0, k=QUERY_K,
                        at_least_version=ref["version"], timeout=60)
        check(got["version"] >= 2, f"{tag}: at_least_version read {got}")
        same_answers(2)
        torch.cuda.synchronize()
        runs[tag] = swap_launches(tag, ops.launch_counts(), 2)
        fits(pub._data.size, f"{tag} v2")
        times = {}
        for name, cl in (("writer", wcl), ("replica", rcl)):
            sc, bt = [], []
            for i in range(HTTP_SCALARS):
                t0 = time.perf_counter()
                cl.query(entity=ents[i], k=QUERY_K)
                sc.append((time.perf_counter() - t0) * 1e3)
            for _ in range(HTTP_BATCHES):
                t0 = time.perf_counter()
                cl.query_batch(ents, k=QUERY_K)
                bt.append((time.perf_counter() - t0) * 1e3)
            times[name] = (pct(sc), pct(bt))
        st, rst = svc.stats(), rep.stats()
        log(f"{tag}: {len(svc.snapshot().index)} clusters at v2; writer "
            f"HTTP, replica HTTP and in-process answers equal at v1 and v2 "
            f"(scalar, batch of {len(ents)}, top-{QUERY_K} with components "
            f"{n_hits} members, signature round-trip); launches "
            f"{per_swap} x 2 swaps; last shm publish "
            f"{st['last_shm_publish_ms']:.3f} ms, bundle {pub._data.size} "
            f"bytes; replica last attach {rst['last_attach_ms']:.3f} ms "
            f"({rst['attaches']} attaches)")
        for name, (sc, bt) in times.items():
            log(f"{tag}: {name} HTTP, {HTTP_SCALARS} scalar queries {sc}; "
                f"{HTTP_BATCHES} batches of {len(ents)} {bt}")
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        rep.stop()
        svc.stop()
        pub.close()
    check(not shm_segments(prefix), f"{tag}: segments left: "
          f"{shm_segments(prefix)}")

    # the plane's rows, split as its writers split them
    ctx = load_dataset("bibsonomy", PLANE_ROWS, 0)
    own = RS.shard_of_rows(ctx.tuples, K.plan_mode_key(
        ctx.sizes, 0, with_values=False), PLANE_SHARDS)
    split = [int((own == s).sum()) for s in range(PLANE_SHARDS)]
    log(f"phase 13 plane: {PLANE_ROWS} BibSonomy-shaped rows split "
        f"{split} over {PLANE_SHARDS} writers (shard_of_rows)")
    env = dict(os.environ, PYTHONPATH=str(SRC))

    def launch(tmp, name, *flags):
        """Start a plane; returns (process, its log path, client)."""
        port_file = os.path.join(tmp, f"{name}.port")
        out = os.path.join(tmp, f"{name}.log")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.cluster_serve",
             "--dataset", "bibsonomy", "--n-tuples", str(PLANE_ROWS),
             "--shards", str(PLANE_SHARDS), "--replicas",
             str(PLANE_REPLICAS), "--device", "cuda", "--port", "0",
             "--port-file", port_file, "--metrics", *flags],
            env=env, cwd=str(ROOT), stdout=open(out, "w"),
            stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 300
        while not (os.path.exists(port_file)
                   and open(port_file).read().strip()):
            check(proc.poll() is None and time.monotonic() < deadline,
                  f"{name}: no router port (rc {proc.poll()}): "
                  + open(out).read()[-3000:])
            time.sleep(0.2)
        cl = ClusterClient(f"http://127.0.0.1:{open(port_file).read()}",
                           timeout=600)
        cl.wait_ready(timeout=300)
        return proc, out, cl, port_file

    def children(out):
        """{child: (pid, port)} as the children announce themselves."""
        found = {}
        for m in re.finditer(r"\[(replica-\d+\.\d+|shard-\d+)\][^\[]*"
                             r"port=(\d+) pid=(\d+)", open(out).read()):
            found[m.group(1)] = (int(m.group(3)), int(m.group(2)))
        return found

    def writer_launches(port):
        text = urllib_get(f"http://127.0.0.1:{port}/metrics")
        counts = {k: 0 for k in ops.KERNELS}
        for name, n in re.findall(r'repro_kernel_launches\{kernel="(\w+)"\}'
                                  r" ([0-9.e+]+)", text):
            counts[name] = int(float(n))
        return counts

    def stop(proc, cl, out, what):
        with contextlib.suppress(Exception):
            cl.shutdown()
        try:
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(rc == 0,
              f"{what}: launcher rc {rc}: " + open(out).read()[-3000:])
        left = shm_segments(f"cs{proc.pid}s")
        check(not left, f"{what}: segments left in {SHM}: {left}")

    def context_holders(found, launcher, what):
        writers = {pid for c, (pid, _) in found.items()
                   if c.startswith("shard")}
        others = {pid for c, (pid, _) in found.items()
                  if c.startswith("replica")} | {launcher}
        apps = compute_apps()
        fds = {c: device_fds(pid) for c, (pid, _) in sorted(found.items())}
        fds["launcher"] = device_fds(launcher)
        log(f"{what}: nvidia-smi compute apps {apps}; this process "
            f"{os.getpid()}, writers {sorted(writers)}, replicas and "
            f"router {sorted(others)}; device files open {fds}")
        check(len(apps) == 1 + PLANE_SHARDS, f"{what}: {len(apps)} CUDA "
              f"contexts, want this process and {PLANE_SHARDS} writers")
        if os.getpid() in apps:     # the listing speaks this namespace
            check(set(apps) == {os.getpid()} | writers,
                  f"{what}: CUDA contexts {apps}")
        replicas = [c for c in fds if c.startswith("replica")]
        check(not any(fds[c] for c in replicas),
              f"{what}: a replica opened the card: {fds}")

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the plane
        tag = "phase 13b plane"
        t0 = time.perf_counter()
        proc, out, cl, port_file = launch(tmp, "p13b")
        try:
            boot_s = time.perf_counter() - t0
            deadline = time.monotonic() + 120
            while len(children(out)) < PLANE_SHARDS * (1 + PLANE_REPLICAS):
                check(time.monotonic() < deadline, f"{tag}: children "
                      f"{children(out)}")
                time.sleep(0.2)
            found = children(out)
            context_holders(found, proc.pid, tag)
            t1 = time.perf_counter()
            top = cl.query(k=QUERY_K, include_components=True)
            batch_ents = rng.integers(0, max(ctx.sizes),
                                      PLANE_BATCH).tolist()
            batch = cl.query_batch(batch_ents, k=QUERY_K)
            query_ms = (time.perf_counter() - t1) * 1e3
            check(top["shard_versions"] == [1] * PLANE_SHARDS
                  and not top["degraded"], f"{tag}: {top['shard_versions']}")
            # the same shards in this process, on the card, merged
            tops, batches = [], []
            for s in range(PLANE_SHARDS):
                rows = ctx.tuples[own == s]
                ref = TriclusterService(ctx.sizes, device="cuda",
                                        seed=0x5EED, **quiet)
                sstep = -(-max(rows.shape[0], 1) // 4)
                for lo in range(0, rows.shape[0], sstep):
                    ref.add(rows[lo:lo + sstep])
                ref.start()
                tops.append(docs(ref.query(k=QUERY_K).hits, True))
                batches.append([docs(h) for h in ref.query_batch(
                    batch_ents, k=QUERY_K).hits])
                ref.stop()
            check(top["hits"] == _merge_hits(tops, QUERY_K),
                  f"{tag}: the router's top-{QUERY_K} differs from the "
                  "in-process shards merged")
            check(batch["hits"] == [
                _merge_hits([b[i] for b in batches], QUERY_K)
                for i in range(PLANE_BATCH)],
                f"{tag}: the router's batch differs from the in-process "
                "shards merged")
            stats = cl.stats()
            launches = {k: 0 for k in ops.KERNELS}
            for s in range(PLANE_SHARDS):
                counts = swap_launches(
                    f"{tag} shard-{s}",
                    writer_launches(found[f"shard-{s}"][1]),
                    stats["shard_stats"][s]["publishes"])
                launches = {k: launches[k] + counts[k] for k in launches}
            runs[f"{tag} writers"] = launches
            for s, st in enumerate(stats["shard_stats"]):
                log(f"{tag} shard-{s}: {st['clusters']} clusters, mine "
                    f"{st['last_mine_ms']:.3f} ms, index build "
                    f"{st['last_index_build_ms']:.3f} ms, shm publish "
                    f"{st.get('last_shm_publish_ms', 0.0):.3f} ms")
            sizes = {seg: os.stat(os.path.join(SHM, seg)).st_size
                     for seg in shm_segments(f"cs{proc.pid}s")}
            fits(max(sizes.values()), f"{tag} {sizes}")
            log(f"{tag}: router up in {boot_s:.1f} s; top-{QUERY_K} and a "
                f"batch of {PLANE_BATCH} equal to the in-process shards "
                f"merged ({query_ms:.3f} ms both); writer launches "
                f"{launches}")
            smoke = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.cluster_serve",
                 "--smoke-client", "--port-file", port_file], env=env,
                cwd=str(ROOT), capture_output=True, text=True, timeout=300)
            check(smoke.returncode == 0 and "[serve-smoke] PASS"
                  in smoke.stdout, f"{tag}: smoke client rc "
                  f"{smoke.returncode}: {smoke.stdout[-2000:]}"
                  f"{smoke.stderr[-2000:]}")
            print("\n".join(ln for ln in smoke.stdout.splitlines()
                            if "ready" not in ln), flush=True)
        finally:
            stop(proc, cl, out, tag)
        log(f"{tag}: launcher exited 0, no segment left in {SHM}")

        # (c) a writer killed at its first write after the preload
        tag = "phase 13c writer crash and recovery"
        plan = FaultPlan.build(FaultPlan.kill_writer(0, at_stream_version=5))
        proc, out, cl, _ = launch(tmp, "p13c", "--fault-plan",
                                  plan.to_json(), "--router-timeout", "600")
        try:
            mine = ctx.tuples[own == 0]
            users, n_rows = np.unique(mine[:, 0], return_counts=True)
            user = int(users[np.argmin(n_rows)])
            row = mine[mine[:, 0] == user][0].copy()
            row[2] = (row[2] + 1) % ctx.sizes[2]     # a new bookmark
            check(RS.shard_of_rows(row[None], K.plan_mode_key(
                ctx.sizes, 0, with_values=False), PLANE_SHARDS)[0] == 0,
                f"{tag}: row {row.tolist()} left shard 0")
            t0 = time.perf_counter()
            up = cl.upsert([row.tolist()])
            write_s = time.perf_counter() - t0
            check(up["shards"] == [0], f"{tag}: upsert {up}")
            tok = cl.refresh()["shard_versions"]
            got = cl.query(entity=user, mode=0, k=10**6,
                           include_components=True, at_least_version=tok,
                           timeout=300)
            check(any(all(int(row[j]) in h["components"][j]
                          for j in range(3)) for h in got["hits"]),
                  f"{tag}: no cluster of the written row {row.tolist()} at "
                  f"{got['shard_versions']}")
            metrics = urllib_get(f"{cl.base_url}/metrics")
            restarts = {c: float(n) for c, n in re.findall(
                r'repro_supervisor_child_restarts\{child="([^"]+)"\} '
                r"([0-9.]+)", metrics)}
            check(restarts.get("shard-0") == 1.0 and sum(restarts.values())
                  == 1.0, f"{tag}: restarts {restarts}")
            log_text = open(out).read()
            check("[shard-0] recovered" in log_text,
                  f"{tag}: no recovery line: {log_text[-3000:]}")
            recovered = re.search(r"\[shard-0\] recovered (\{[^}]*\})",
                                  log_text).group(1)
            found = children(out)
            pubs = cl.stats()["shard_stats"][0]["publishes"]
            counts = swap_launches(tag, writer_launches(found["shard-0"][1]),
                                   pubs)
            runs[f"{tag} restarted shard-0"] = counts
            log(f"{tag}: the write to shard 0 came back after {write_s:.1f} "
                f"s (kill, restart, recovery {recovered}); the "
                f"at_least_version read at {tok} returns the row's cluster; "
                f"router /metrics restarts {restarts}; the restarted writer "
                f"launched {counts} over {pubs} swaps")
        finally:
            stop(proc, cl, out, tag)
        log(f"{tag}: launcher exited 0, no segment left in {SHM}")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return runs


def train_reckoning(n_params: int, cfg, tokens: int) -> dict:
    """Phase 14a's memory reckoning in bytes: fp32 params, grads, m and v;
    the step's bf16 copy of the tree; the stacked leaves' bf16 cotangents
    before their cast; the block inputs remat keeps; the fp32 logits,
    log-softmax and their gradients."""
    out = {"fp32 params, grads, m, v": 4 * 4 * n_params,
           "bf16 tree": 2 * n_params,
           "bf16 cotangents": 2 * n_params,
           "remat block inputs": cfg.n_layers * tokens * cfg.d_model * 2,
           "fp32 logits, log-softmax, grads": 3 * tokens * cfg.vocab_size
           * 4}
    out["total"] = sum(out.values())
    return out


def phase14() -> dict:
    """Training: ``launch.train`` at full width (14a), its fp32 gate at
    ``GATE_LAYERS`` depth against the CPU (14b), the driver's resume and a
    checkpoint round trip at smoke size (14c), the supervised crash and
    restart (14d).  -> {run: launch counts}, all zero."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models.params import tree_items, tree_map
    from repro_torch.models.telemetry import collect_moe_routing
    from repro_torch.train import step as TS
    from repro_torch.train.checkpoints import CheckpointManager

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    runs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke14_")

    def zero_launches(tag: str) -> dict:
        counts = ops.launch_counts()
        check(all(n == 0 for n in counts.values()),
              f"{tag}: kernel launches {counts} on the training path (its "
              "kernels have no backward: none may launch)")
        return counts

    # 14a: full width and depth through the driver
    arch = "granite-moe-3b-a800m"
    cfg = get_config(arch)
    check(cfg.dtype == "bfloat16" and cfg.remat == "block"
          and cfg.attn_impl == "blocked" and not cfg.use_pallas,
          f"{arch}: dtype {cfg.dtype}, remat {cfg.remat}, attn_impl "
          f"{cfg.attn_impl}, use_pallas {cfg.use_pallas}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    reck = train_reckoning(cfg.n_params(), cfg, tokens)
    tag = "phase 14a training granite-moe"
    metrics_path = os.path.join(tmp, "14a.json")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = train_mod.main(["--arch", arch, "--global-batch", str(TRAIN_BATCH),
                         "--seq", str(TRAIN_SEQ), "--steps",
                         str(TRAIN_STEPS), "--lr", "3e-3", "--warmup", "2",
                         "--log-every", "1", "--metrics-out", metrics_path,
                         "--device", "cuda"])
    wall = time.perf_counter() - t0
    runs[tag] = zero_launches(tag)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"{tag}: rc {rc}")
    rows = json.load(open(metrics_path))
    check([r["step"] for r in rows] == list(range(1, TRAIN_STEPS + 1)),
          f"{tag}: rows {[r['step'] for r in rows]}")
    for r in rows:
        check(all(math.isfinite(r[k]) for k in ("loss", "grad_norm", "lr")),
              f"{tag}: step {r['step']} {r}")
    step_ms = [tokens / r["tok_per_s"] * 1e3 for r in rows]
    warm = step_ms[1:]
    warm_ms = sum(warm) / len(warm)
    log(f"{tag}: {cfg.n_params()} parameters, {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens a step, bf16 compute over fp32 master, remat block, "
        f"attention blocked; {TRAIN_STEPS} steps in {wall:.1f} s (init "
        f"included)")
    for r, ms in zip(rows, step_ms):
        log(f"  step {r['step']}: loss {r['loss']:.6f} grad norm "
            f"{r['grad_norm']:.6f} lr {r['lr']:.6e} ({ms:.3f} ms)")
    log(f"{tag}: warm step ms {[round(x, 3) for x in warm]} (mean "
        f"{warm_ms:.3f}, min {min(warm):.3f}); {tokens / (warm_ms / 1e3):.1f}"
        f" tokens/s; peak device memory {peak} bytes ({peak / 1e9:.3f} GB) "
        f"against the reckoning's {reck['total'] / 1e9:.3f} GB ("
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in reck.items()
                    if k != "total")
        + f"); kernel launches {runs[tag]}")
    check(peak <= torch.cuda.get_device_properties(0).total_memory,
          f"{tag}: peak {peak}")
    # one more step under the profiler: where the step's device time goes
    state = TS.init_train_state(cfg, torch.Generator(device=dev)
                                .manual_seed(0), device=dev)
    step_fn = TS.make_train_step(cfg, None, TS.TrainConfig(
        peak_lr=3e-3, warmup_steps=2, total_steps=TRAIN_STEPS))
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    box = {"state": state}

    def one_step():
        box["state"], m = step_fn(box["state"], batch)
        float(m["loss"])

    t0 = time.perf_counter()
    one_step()
    host_ms = (time.perf_counter() - t0) * 1e3
    del state
    busy, by_name, by_op, complete = device_ms(one_step, iters=1, warm=False)
    if busy is not None:
        log(f"{tag} profiled step (host {host_ms:.3f} ms unprofiled): device "
            f"busy {busy:.3f} ms (idle share {1 - busy / warm_ms:.3f} of the "
            f"driver's warm step; trace complete: {complete}); device ms by "
            f"the PyTorch op that launched it, the largest:")
        for oname, oms in sorted(by_op.items(), key=lambda kv: -kv[1])[:14]:
            log(f"    {oms:.3f} ms  {oname[:90]}")
    del box, batch, step_fn
    torch.cuda.empty_cache()

    # 14b: the fp32 gate at GATE_LAYERS depth, full width: card and CPU.
    # Tolerances from scripts/torch_train_conditioning.py: at this size the
    # CPU's float32 step is 8.2e-7 (loss), 6.0e-5 (grad norm) and up to
    # 1.2e-3 of a leaf's max |gradient| from float64 (logits of ~100s at
    # this init leave their rounding in the softmax's gradient), and two
    # correct float32 runs can each be that far: the loss 1e-5, the grad
    # norm 5e-4, m (a gradient) 5e-3 and v (its square) 1e-2 of the leaf's
    # max.  The parameter update is held two ways: bit for bit against
    # AdamW applied on the host to the card's own moments and bias
    # corrections (the same correctly rounded float32 operations in the
    # same order; the square root through float64, since the host's
    # float32 ``torch.sqrt`` misses the correctly rounded root by an ulp
    # in ~0.5% of elements where the card's does not), and
    # against the CPU's where the update is not the sign of rounding noise
    # (|m| >= 2e-2 of its leaf's max and m / (1 - b1) >= 1e-5 = 1000 eps:
    # 1e-3 lr).  No MoE route may differ: a flipped route trains another
    # expert, and no leaf tolerance covers that.
    tag = "phase 14b fp32 gate"
    gcfg = dataclasses.replace(cfg, dtype="float32", n_layers=GATE_LAYERS)
    gtc = TS.TrainConfig(peak_lr=3e-3, warmup_steps=0,
                         total_steps=TRAIN_STEPS)
    card = TS.init_train_state(gcfg, torch.Generator(device=dev)
                               .manual_seed(0), device=dev)
    host0 = tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(),
                     card)
    cpu = TS.from_jax_state(host0, device="cpu")
    gbatch = TokenPipeline(gcfg, 1, 512, seed=0).batch_at(0)
    r_card = collect_moe_routing(gcfg, card["params"], gbatch["tokens"])
    r_cpu = collect_moe_routing(gcfg, cpu["params"], gbatch["tokens"])
    flips = int((np.asarray(r_card) != np.asarray(r_cpu)).sum())
    ops.reset_launch_counts()
    card, m_card = TS.make_train_step(gcfg, None, gtc)(
        card, {k: torch.from_numpy(v).to(dev) for k, v in gbatch.items()})
    torch.cuda.synchronize()
    runs[tag] = zero_launches(tag)
    t0 = time.perf_counter()
    cpu, m_cpu = TS.make_train_step(gcfg, None, gtc)(
        cpu, {k: torch.from_numpy(v) for k, v in gbatch.items()})
    cpu_s = time.perf_counter() - t0
    lr = float(m_cpu["lr"])
    rel = {k: abs(float(m_card[k]) - float(m_cpu[k]))
           / max(abs(float(m_cpu[k])), 1e-30)
           for k in ("loss", "nll", "aux", "grad_norm")}
    err = {"m": {}, "v": {}, "update": {}, "params": {}}
    for part in ("m", "v"):
        for (path, x), (_, y) in zip(tree_items(card["opt"][part]),
                                     tree_items(cpu["opt"][part])):
            err[part][path] = float((x.cpu() - y).abs().max()) / max(
                float(y.abs().max()), 1e-30)
    t = card["opt"]["step"].to(torch.float32)
    bc1, bc2 = ((1.0 - b ** t).cpu() for b in (gtc.b1, gtc.b2))  # the card's
    cm, cv = dict(tree_items(card["opt"]["m"])), dict(tree_items(
        card["opt"]["v"]))
    pm = dict(tree_items(cpu["opt"]["m"]))
    p0s = dict(tree_items(host0["params"]))
    compared = 0
    for (path, pc), (_, pp) in zip(tree_items(card["params"]),
                                   tree_items(cpu["params"])):
        p0 = torch.from_numpy(p0s[path])
        root = torch.sqrt((cv[path].cpu() / bc2).double()).float()
        want = p0 - m_cpu["lr"] * (cm[path].cpu() / bc1 / (root + 1e-8)
                                   + gtc.weight_decay * p0)
        got = pc.detach().cpu()
        big = torch.maximum(torch.maximum(p0.abs(), want.abs()),
                            torch.tensor(lr))     # the operands' scale
        ulp = torch.nextafter(big, torch.tensor(math.inf)) - big
        err["update"][path] = float(((got - want).abs() / ulp).max())
        mc = pm[path].abs()
        sure = (mc >= 2e-2 * float(mc.max())) & (mc / bc1 >= 1e-5)
        compared += int(sure.sum())
        d = (got - pp.detach())[sure].abs()
        err["params"][path] = float(d.max()) / lr if d.numel() else 0.0
    worst = {k: max(v.values()) for k, v in err.items()}
    n_el = sum(x.numel() for _, x in tree_items(cpu["params"]))
    log(f"{tag} ({GATE_LAYERS} of {cfg.n_layers} layers, full width, 1 x 512 "
        f"tokens, one step at lr {lr:.3e}; the CPU step {cpu_s:.1f} s): "
        f"routes differing card/CPU {flips} of {np.asarray(r_cpu).size}; "
        f"loss {float(m_card['loss']):.6f} / {float(m_cpu['loss']):.6f}, "
        f"grad norm {float(m_card['grad_norm']):.6f} / "
        f"{float(m_cpu['grad_norm']):.6f}; relative differences "
        + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
        + f" (limits 1e-5, grad norm 5e-4); max |err| of m {worst['m']:.3e} "
        f"and v {worst['v']:.3e} of their leaves' max (limits 5e-3, 1e-2); "
        f"the card's update from its own moments within "
        f"{worst['update']:.3f} ulp of max(|p|, |p'|, lr) (limit 0); params "
        f"against the CPU's "
        f"within {worst['params']:.3e} lr (limit 1e-3) at {compared} of "
        f"{n_el} elements")
    for part in ("m", "v"):
        log(f"  {part} by leaf: " + ", ".join(
            f"{'/'.join(k)} {v:.2e}" for k, v in err[part].items()))
    for k, v in rel.items():
        check(v <= (5e-4 if k == "grad_norm" else 1e-5),
              f"{tag}: {k} {float(m_card[k])} on the card, "
              f"{float(m_cpu[k])} on the CPU ({flips} routes differ)")
    check(flips == 0, f"{tag}: {flips} MoE routes differ between the card "
          "and the CPU, so the two steps train different experts")
    check(float(m_card["lr"]) == lr > 0, f"{tag}: lr {m_card['lr']} / {lr}")
    for part, limit in (("m", 5e-3), ("v", 1e-2), ("update", 0.0),
                        ("params", 1e-3)):
        check(worst[part] <= limit, f"{tag}: {part} {err[part]} (limit "
              f"{limit}; {flips} routes differ between the card and the CPU)")
    del card, cpu, host0, cm, cv, pm, p0s
    torch.cuda.empty_cache()

    # 14c: the driver at smoke size on the card; resume; checkpoint
    tag = "phase 14c driver danube smoke"
    smoke = ["--arch", "h2o-danube-1.8b", "--smoke", "--global-batch", "2",
             "--seq", "32", "--steps", "6", "--log-every", "1",
             "--device", "cuda"]
    straight, resumed = (os.path.join(tmp, f"14c_{n}") for n in "ab")
    ops.reset_launch_counts()
    check(train_mod.main(smoke + ["--ckpt-dir", straight, "--ckpt-every", "3",
                                  "--metrics-out", straight + ".json"]) == 0,
          f"{tag}: the straight run failed")
    ckpt3 = CheckpointManager(straight)._path(3)
    check(os.path.isdir(ckpt3), f"{tag}: no step-3 checkpoint")
    os.makedirs(resumed)
    shutil.copytree(ckpt3, os.path.join(resumed, os.path.basename(ckpt3)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_mod.main(smoke + ["--ckpt-dir", resumed, "--resume",
                                     "auto", "--metrics-out",
                                     resumed + ".json"])
    check(rc == 0 and "resumed from step 3" in out.getvalue(),
          f"{tag}: the resumed run: {out.getvalue()[-2000:]}")
    runs[tag] = zero_launches(tag)
    a_rows = json.load(open(straight + ".json"))
    b_rows = json.load(open(resumed + ".json"))
    check([r["step"] for r in b_rows] == [4, 5, 6], f"{tag}: resumed rows "
          f"{[r['step'] for r in b_rows]}")
    diffs = {"loss": 0.0, "grad_norm": 0.0, "lr": 0.0}
    for a, b in zip(a_rows[3:], b_rows):
        for k in diffs:
            diffs[k] = max(diffs[k], abs(a[k] - b[k]) / abs(a[k]))
    check(all(v == 0.0 for v in diffs.values()), f"{tag}: 6 straight against"
          f" 3 + resume + 3: relative differences {diffs}")
    ends = [tree_items(CheckpointManager(d).restore(6)[1])
            for d in (straight, resumed)]
    check([p for p, _ in ends[0]] == [p for p, _ in ends[1]] and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for (_, a), (_, b) in zip(*ends)),
        f"{tag}: the step-6 states of 6 straight and 3 + resume + 3 differ "
        "in " + ", ".join("/".join(p) for (p, a), (_, b) in zip(*ends)
                          if not np.array_equal(a, b)))
    scfg = get_smoke_config("h2o-danube-1.8b")
    st = TS.init_train_state(scfg, torch.Generator(device=dev).manual_seed(3),
                             device=dev)
    fn = TS.make_train_step(scfg, None, TS.TrainConfig(warmup_steps=1))
    sb = {k: torch.from_numpy(v).to(dev) for k, v in
          TokenPipeline(scfg, 2, 32, seed=3).batch_at(0).items()}
    for _ in range(2):
        st, _ = fn(st, sb)
    mgr = CheckpointManager(os.path.join(tmp, "14c_roundtrip"))
    mgr.save(2, st, block=False)
    mgr.wait()
    _, back = mgr.restore(template=st, device="cpu")
    pairs = list(zip(tree_items(st), tree_items(back)))
    check(len(pairs) == len(tree_items(back)) and all(
        pa == pb and b.device.type == "cpu" and a.dtype == b.dtype
        and torch.equal(a.detach().cpu(), b) for (pa, a), (pb, b) in pairs),
        f"{tag}: a checkpoint written on the card does not restore leaf "
        "for leaf on the CPU")
    log(f"{tag}: 6 steps straight against 3 + --resume auto + 3: the rows "
        f"of steps 4-6 equal (loss, grad norm, lr) and the step-6 states "
        f"equal in all {len(ends[0])} leaves of params, opt/m, opt/v, "
        f"opt/step, data_step; a checkpoint of {len(pairs)} leaves written on"
        " the card restores with device='cpu' leaf for leaf equal")

    # 14d: the supervised crash, restart and resume, as the example runs it
    tag = "phase 14d supervisor"
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_fault_tolerance_demo
    torch_fault_tolerance_demo.main(["--device", "cuda"])
    log(f"{tag}: examples/torch_fault_tolerance_demo.py on the card: the "
        f"injected crash (rc 42), the restart resumed from its last "
        f"checkpoint and ran to step 60 ({time.perf_counter() - t0:.1f} s)")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return runs


#: Phase 15: the model on a device mesh.  15b's serving mesh (data, model)
#: and 15c's training mesh, both gloo groups on the one card (NCCL takes
#: one rank a card, so their collectives stage through host memory);
#: 15b's prompts (4 of about MESH_PROMPT tokens), new tokens and ring
#: (MESH_MAX_LEN slots, split in two blocks of 640 over "model", both
#: holding filled slots from the prefill on); 15c's batch of
#: MESH_TRAIN_BATCH x MESH_TRAIN_SEQ tokens (the batch splits over
#: "data") and the steps of its ZeRO-1 state: three, then one with the
#: gspmd MoE dispatch (a fresh state in the fsdp layout takes one more).
SERVE_MESH, TRAIN_MESH = (1, 2), (2, 2)
MESH_PROMPT, MESH_NEW, MESH_MAX_LEN = 1024, 16, 1280
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 512
MESH_STEPS = ("zero1", "zero1", "zero1", "gspmd")


def _rank_setup(rank: int, world: int, tmp: str, name: str):
    """A spawned gloo rank on ``cuda:0``: (torch, dist) after joining."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores (host work: gloo, staging, launches)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/{name}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    return torch, dist


class _Recorder:
    """A model's ``prefill``/``decode_step`` that keep each call's logits
    and the staged collectives it issued (``ServeEngine.model``)."""

    def __init__(self, model, keep_logits: bool = False):
        from repro_torch.core.collectives import Collectives
        self.model, self.keep = model, keep_logits
        self.C = Collectives
        self.logits, self.comms = [], []

    def _call(self, fn, *args):
        c0, b0 = self.C.calls, self.C.bytes
        cache, logits = fn(*args)
        self.comms.append((self.C.calls - c0, self.C.bytes - b0))
        if self.keep:
            self.logits.append(logits.detach().clone())
        return cache, logits

    def prefill(self, *args):
        return self._call(self.model.prefill, *args)

    def decode_step(self, *args):
        return self._call(self.model.decode_step, *args)


def phase15b_rank(rank: int, tmp: str) -> None:
    """One of 15b's two serving ranks (mesh ``SERVE_MESH``): granite-moe at
    full width and depth, bf16, both kernels; then the fp32 gate at
    ``GATE_LAYERS`` depth.  Rank 0 also runs the one-rank references on
    the card.  Writes ``tmp/rank<r>.json``."""
    torch, dist = _rank_setup(rank, 2, tmp, "pg15b")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.collectives import Collectives
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm as L
    from repro_torch.models.api import get_model
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import MeshRules
    dev = torch.device("cuda", 0)
    report = {"rank": rank}
    try:
        mesh = make_mesh(SERVE_MESH, ("data", "model"), device=dev)
        rules = MeshRules(mesh)
        report["staged"] = mesh.staged
        cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                                  attn_impl="pallas", use_pallas=True)
        model = get_model(cfg)
        t0 = time.perf_counter()
        params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, rules=rules)
        torch.cuda.synchronize()
        report["init_s"] = time.perf_counter() - t0
        report["param_bytes"] = sum(p.numel() * p.element_size()
                                    for p in params.parameters())
        prompts = TokenPipeline(cfg, 4, MESH_PROMPT, seed=0).prompts(
            4, MESH_PROMPT)
        report["prompt_lens"] = [len(p) for p in prompts]
        engine = ServeEngine(cfg, params, max_len=MESH_MAX_LEN, rules=rules)
        engine.generate(prompts, 2)                           # warm-up
        rec = _Recorder(engine.model)
        engine.model = rec
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        ops.reset_launch_counts()
        Collectives.reset_counts()
        res = engine.generate(prompts, MESH_NEW)
        report["counts"] = ops.launch_counts()
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
        report.update(prefill_ms=res.prefill_s * 1e3,
                      decode_ms=res.decode_s * 1e3, steps=res.steps,
                      tokens=res.tokens,
                      prefill_comms=list(rec.comms[0]),
                      decode_comms=[sum(c[0] for c in rec.comms[1:]),
                                    sum(c[1] for c in rec.comms[1:])])
        del engine, rec, params
        torch.cuda.empty_cache()
        dist.barrier()
        if rank == 0:          # the one-rank card run of the same draws
            full = model.init(cfg, torch.Generator(device=dev)
                              .manual_seed(0), device=dev)
            one = ServeEngine(cfg, full, max_len=MESH_MAX_LEN).generate(
                prompts, MESH_NEW)
            report["one_rank_tokens"] = one.tokens
            del full
            torch.cuda.empty_cache()
        dist.barrier()

        # the fp32 gate at GATE_LAYERS depth, teacher-forced on the mesh's
        # greedy tokens: prefill and every decode step's logits
        gcfg = dataclasses.replace(cfg, dtype="float32",
                                   n_layers=GATE_LAYERS)
        gmodel = get_model(gcfg)
        toks = TokenPipeline(gcfg, 4, MESH_PROMPT, seed=1).batch_at(0)[
            "tokens"]

        def teacher_forced(p, rules_, feed=None):
            cache, lg = gmodel.prefill(gcfg, p, {"tokens": toks},
                                       MESH_MAX_LEN, rules_)
            rows, fed = [lg], []
            for i in range(MESH_NEW):
                nxt = torch.argmax(lg, -1) if feed is None else feed[i]
                fed.append(nxt)
                cache, lg = gmodel.decode_step(gcfg, p, cache, nxt, rules_)
                rows.append(lg)
            return rows, fed

        def teacher_forced_cfg(c, p, feed):
            cache, lg = gmodel.prefill(c, p, {"tokens": toks},
                                       MESH_MAX_LEN, None)
            out = [lg]
            for nxt in feed:
                cache, lg = gmodel.decode_step(c, p, cache, nxt, None)
                out.append(lg)
            return out

        gp = gmodel.init(gcfg, torch.Generator(device=dev).manual_seed(1),
                         device=dev, rules=rules)
        ops.reset_launch_counts()
        rows, fed = teacher_forced(gp, rules)
        report["gate_counts"] = ops.launch_counts()
        del gp
        if rank == 0:
            gfull = gmodel.init(gcfg, torch.Generator(device=dev)
                                .manual_seed(1), device=dev)
            want, _ = teacher_forced(gfull, None, fed)

            def rel(xs, ys):
                return [float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(xs, ys)]
            report["gate_rel"] = rel(rows, want)
            report["gate_tokens_equal"] = all(
                torch.equal(torch.argmax(a, -1), torch.argmax(b, -1))
                for a, b in zip(rows, want))
            # two correct one-rank runs at this depth and width: kernels
            # on against off (phase 9b's gate), and float32 against the
            # compute in float64 (``lm.compute_dtype`` swapped, the plain
            # paths; scripts/torch_mesh_conditioning.py does the same)
            gcfg_off = dataclasses.replace(gcfg, attn_impl="blocked",
                                           use_pallas=False)
            off = teacher_forced_cfg(gcfg_off, gfull, fed)
            report["gate_rel_kernels_off"] = rel(want, off)
            del gfull
            real = L.compute_dtype
            L.compute_dtype = lambda c: torch.float64
            try:
                g64 = gmodel.init(gcfg, torch.Generator(device=dev)
                                  .manual_seed(1), dtype=torch.float64,
                                  device=dev)
                exact = [x.double() for x in
                         teacher_forced_cfg(gcfg_off, g64, fed)]
            finally:
                L.compute_dtype = real
            del g64
            report["gate_rel_f64"] = {
                "mesh": rel([x.double() for x in rows], exact),
                "one rank": rel([x.double() for x in want], exact)}
        dist.barrier()
    finally:
        dist.destroy_process_group()
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(report, f)


def phase15c_rank(rank: int, tmp: str) -> None:
    """One of 15c's four training ranks (mesh ``TRAIN_MESH``): granite-moe
    at full width and ``GATE_LAYERS`` depth in fp32, ZeRO-1.  A state in
    the ZeRO-1 layout takes the steps of ``MESH_STEPS`` (three, then one
    with the gspmd dispatch), and a fresh state in the fsdp layout one
    step.  Each rank also runs the one-rank train step on the card from
    the same state, on the mesh's routes (its own top-k is recorded,
    then replaced by the mesh's, gathered over ``data``), holds its
    blocks against the matching blocks of that state after every step,
    and takes them for the next step.
    Then a checkpoint the four ranks saved is restored, whole, on each
    rank and held block for block against the live state.  Writes
    ``tmp/rank<r>.json``."""
    torch, dist = _rank_setup(rank, 4, tmp, "pg15c")
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import common as C
    from repro_torch.models.params import tree_items
    from repro_torch.sharding import MeshRules
    from repro_torch.train import step as TS
    from repro_torch.train.checkpoints import CheckpointManager
    dev = torch.device("cuda", 0)
    report = {"rank": rank, "steps": []}
    try:
        mesh = make_mesh(TRAIN_MESH, ("data", "model"), device=dev)
        report["staged"] = mesh.staged
        base = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                                   dtype="float32", n_layers=GATE_LAYERS)
        cfgs = {"zero1": base,
                "fsdp": dataclasses.replace(base, fsdp=True),
                "gspmd": dataclasses.replace(base, moe_impl="gspmd")}
        rules = {k: MeshRules(mesh, fsdp=c.fsdp) for k, c in cfgs.items()}
        tc = TS.TrainConfig(peak_lr=3e-3, warmup_steps=0,
                            total_steps=TRAIN_STEPS, zero1=True)
        shard = {k: TS.state_shardings(cfgs[k], rules[k], tc) for k in cfgs}
        steps = {k: TS.make_train_step(cfgs[k], rules[k], tc) for k in cfgs}
        one_step = TS.make_train_step(base, None, tc)
        data = rules["zero1"].comm(("data",))
        pipe = TokenPipeline(base, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ, seed=0)

        def init(layout=None):
            return TS.init_train_state(
                base, torch.Generator(device=dev).manual_seed(0),
                device=dev, shardings=None if layout is None
                else shard[layout])

        # routes: the mesh's top-k recorded; the one-rank step records its
        # own and is given the mesh's (gathered over "data": the full
        # batch), so both steps train the same experts
        # (the gap: how much router probability the mesh's choice gives
        # up in the one-rank step, over the row's largest: 0 where they
        # agree, rounding noise at a near tie)
        routes, forced, gaps = [], [], []
        top_k = C.top_k

        def routed_top_k(x, k):
            v, i = top_k(x, k)
            routes.append(i.detach().reshape(-1))
            if forced:
                i = forced.pop(0).reshape(i.shape)
                w = torch.gather(x, -1, i)
                gaps.append(((v.sum(-1) - w.sum(-1)) / x.amax(-1)).max()
                            .detach())
                v = w
            return v, i
        C.top_k = routed_top_k

        def compare(state, ref, layout, lr):
            """This rank's blocks against the one-rank state's (``m``,
            ``v``, the parameters), then the
            blocks set to the one-rank state's: each step starts both from
            the same state.  (Two states that have parted once part for
            good: AdamW's first update is lr times the sign of the
            gradient, so a gradient at rounding noise moves a weight by
            2 lr one way or the other.)  The ranks' one-rank steps are the
            same computation on the same card, bit for bit."""
            sh = dict(tree_items(shard[layout]))
            refs = dict(tree_items(ref))
            bc1 = 1.0 - tc.b1 ** float(ref["opt"]["step"])
            err = {"m": 0.0, "v": 0.0, "params": 0.0, "scalars_equal": True}
            for p, x in tree_items(state):
                full = refs[p].detach()
                y = sh[p].local(full)
                x = x.detach()
                if p[0] == "opt" and p[1] in ("m", "v"):
                    e = float((x - y).abs().max()) / max(
                        float(full.abs().max()), 1e-30)
                    err[p[1]] = max(err[p[1]], e)
                elif p[0] == "params":
                    mfull = refs[("opt", "m") + p[1:]].abs()
                    mc = sh[("opt", "m") + p[1:]].local(mfull)
                    sure = (mc >= 2e-2 * float(mfull.max())) \
                        & (mc / bc1 >= 1e-5)
                    d = (x - y)[sure].abs()
                    if d.numel():
                        err["params"] = max(err["params"],
                                            float(d.max()) / lr)
                else:
                    err["scalars_equal"] &= bool(torch.equal(x, y))
            with torch.no_grad():
                for p, x in tree_items(state):
                    x.copy_(sh[p].local(refs[p]))
            return err

        def run(kind, layout, state, ref, i):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch_at(i).items()}
            routes.clear()
            old = {p: x.detach().clone() for p, x in tree_items(state)
                   if p[0] == "params"}
            t_old = state["opt"]["step"].clone()
            ops.reset_launch_counts()
            dist.barrier()
            t0 = time.perf_counter()
            state, m = steps[kind](state, batch)
            loss = float(m["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            mine = data.all_gather(torch.stack(routes), 1)  # (calls, B.S.k)
            routes.clear()
            gaps.clear()
            forced.extend(mine.unbind(0))
            ref, rm = one_step(ref, batch)
            check(not forced, "phase 15c: the one-rank step took fewer "
                  "routes than the mesh's")
            theirs = torch.stack(routes)
            flips = mine != theirs
            row = {"kind": kind, "ms": ms, "counts": counts, "loss": loss,
                   "grad_norm": float(m["grad_norm"]),
                   "ref_loss": float(rm["loss"]),
                   "ref_grad_norm": float(rm["grad_norm"]),
                   "lr": float(rm["lr"]), "routes": int(theirs.numel()),
                   "route_flips": int(flips.sum()),
                   "route_gap": float(torch.stack(gaps).max())}
            # the blocks' update is AdamW of their own new moments, in the
            # optimizer's operations and order on the same card: bit for
            # bit (the optimizer on blocks)
            with torch.no_grad():
                lr_t = TS.cosine_lr(t_old, peak=tc.peak_lr,
                                    warmup=tc.warmup_steps,
                                    total=tc.total_steps)
                t = state["opt"]["step"].to(torch.float32)
                bc1, bc2 = 1.0 - tc.b1 ** t, 1.0 - tc.b2 ** t
                mv = dict(tree_items(state["opt"]))
                row["update_equal"] = all(
                    torch.equal(x.detach(), old[p].clone().sub_(
                        (mv[("m",) + p[1:]] / bc1).div_(
                            torch.div(mv[("v",) + p[1:]], bc2).sqrt_()
                            .add_(1e-8)).add_(tc.weight_decay * old[p])
                        .mul_(lr_t)))
                    for p, x in tree_items(state) if p[0] == "params")
            del old
            row["err"] = compare(state, ref, layout, row["lr"])
            report["steps"].append(row)
            print(f"[chip_smoke] phase 15c rank {rank} step {len(report['steps'])}"
                  f" ({kind}): {ms:.1f} ms", flush=True)
            return state, ref

        t0 = time.perf_counter()
        state, ref = init("zero1"), init()
        report["init_s"] = time.perf_counter() - t0
        for i, kind in enumerate(MESH_STEPS):
            state, ref = run(kind, "zero1", state, ref, i)
        del ref
        fstate, fref = init("fsdp"), init()
        run("fsdp", "fsdp", fstate, fref, 0)
        del fstate, fref
        torch.cuda.empty_cache()

        # a checkpoint of the four ranks, restored whole on each rank
        mgr = CheckpointManager(f"{tmp}/ckpt15c", verify_hashes=rank == 0)
        t0 = time.perf_counter()
        mgr.save(len(MESH_STEPS), state, shardings=shard["zero1"])
        report["save_s"] = time.perf_counter() - t0
        print(f"[chip_smoke] phase 15c rank {rank} checkpoint saved in "
              f"{report['save_s']:.1f} s", flush=True)
        t0 = time.perf_counter()
        step_, back = mgr.restore()
        report["restore_s"] = time.perf_counter() - t0
        print(f"[chip_smoke] phase 15c rank {rank} restored in "
              f"{report['restore_s']:.1f} s", flush=True)
        back = dict(tree_items(back))
        sh = dict(tree_items(shard["zero1"]))
        live = dict(tree_items(state))
        report["ckpt_step"] = step_
        report["ckpt_leaves"] = len(back)
        report["ckpt_equal"] = sorted(back) == sorted(live) and all(
            back[p].dtype == x.detach().cpu().numpy().dtype
            and np.array_equal(sh[p].local(back[p]),
                               x.detach().cpu().numpy())
            for p, x in live.items())
        dist.barrier()
    finally:
        dist.destroy_process_group()
        with open(f"{tmp}/rank{rank}.json", "w") as f:
            json.dump(report, f)


def phase15() -> dict:
    """The model on a device mesh (``sharding``, ``models``, ``train``,
    ``serve``): (a) an NCCL group of one rank, mesh (1, 1), granite-moe
    at full width and depth, serving and two training steps bit for bit
    equal to no mesh; (b) two gloo ranks on the card serving it tensor-
    parallel (``SERVE_MESH``) through both kernels, with the fp32 gate;
    (c) four gloo ranks training it at ``GATE_LAYERS`` depth
    (``TRAIN_MESH``), ZeRO-1, fsdp, the gspmd dispatch, a checkpoint.
    -> {run: launch counts}."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import get_model
    from repro_torch.models.params import tree_items
    from repro_torch.serve import ServeEngine
    from repro_torch.sharding import MeshRules
    from repro_torch.train import step as TS

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    runs = {}
    arch = "granite-moe-3b-a800m"
    with tempfile.TemporaryDirectory() as tmp:
        # 15a: (1, 1) over an NCCL group of one rank
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg15a",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            mesh = make_local_mesh(device="cuda")
            check(mesh.group is not None and not mesh.staged
                  and dist.get_backend(mesh.group) == "nccl",
                  "phase 15a: not an NCCL group of one rank")
            rules = MeshRules(mesh)
            cfg = dataclasses.replace(get_config(arch), attn_impl="pallas",
                                      use_pallas=True)
            model = get_model(cfg)
            params = model.init(cfg, torch.Generator(device=dev)
                                .manual_seed(0), device=dev)
            mine = model.init(cfg, torch.Generator(device=dev)
                              .manual_seed(0), device=dev, rules=rules)
            check(all(torch.equal(a, b) for (_, a), (_, b) in
                      zip(tree_items(params), tree_items(mine))),
                  "phase 15a: Model.init(rules=(1, 1)) differs")
            del mine
            prompts = TokenPipeline(cfg, 4, 2048, seed=0).prompts(4, 2048)
            out = {}
            for name, r in (("mesh", rules), ("none", None)):
                eng = ServeEngine(cfg, params, max_len=4096, rules=r)
                eng.model = _Recorder(eng.model, keep_logits=True)
                ops.reset_launch_counts()
                res = eng.generate(prompts, 8)
                out[name] = (res.tokens, eng.model.logits,
                             ops.launch_counts())
            tag = "phase 15a serving (1, 1) mesh"
            runs[tag] = out["mesh"][2]
            check(all(runs[tag][k] > 0 for k in ops.PATH_KERNELS["serving"]),
                  f"{tag}: a kernel of the path was not launched: "
                  f"{runs[tag]}")
            check(out["mesh"][0] == out["none"][0],
                  f"{tag}: tokens differ from rules=None")
            rows = list(zip(out["mesh"][1], out["none"][1]))
            check(all(torch.equal(a, b) for a, b in rows),
                  f"{tag}: logits differ from rules=None at rows "
                  f"{[i for i, (a, b) in enumerate(rows) if not torch.equal(a, b)]}")
            log(f"{tag}: {arch} full width and depth (bf16, both kernels), "
                f"the phase-9b prompts, 8 new tokens: tokens and all "
                f"{len(rows)} logit rows (prefill and each decode step) equal"
                f" to rules=None bit for bit; launches {runs[tag]} (equal to "
                f"rules=None's: {runs[tag] == out['none'][2]})")
            del params, out, rows, eng
            torch.cuda.empty_cache()

            tcfg = get_config(arch)
            tc = TS.TrainConfig(peak_lr=3e-3, warmup_steps=2,
                                total_steps=TRAIN_STEPS)
            pipe = TokenPipeline(tcfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)

            def two_steps(r):
                state = TS.init_train_state(
                    tcfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev, shardings=None if r is None
                    else TS.state_shardings(tcfg, r, tc))
                fn = TS.make_train_step(tcfg, r, tc)
                got = []
                for i in range(2):
                    batch = {k: torch.from_numpy(v).to(dev)
                             for k, v in pipe.batch_at(i).items()}
                    state, m = fn(state, batch)
                    got.append((float(m["loss"]), float(m["grad_norm"])))
                del state, fn
                torch.cuda.empty_cache()
                return got

            tag = "phase 15a training (1, 1) mesh"
            ops.reset_launch_counts()
            with_mesh = two_steps(rules)
            runs[tag] = ops.launch_counts()
            without = two_steps(None)
            spread = None
            if with_mesh != without:
                again = two_steps(None)
                spread = [max(abs(a - b) / abs(b) for a, b in zip(x, y))
                          for x, y in zip(without, again)]
                log(f"{tag}: two rules=None runs differ on the card by "
                    f"{spread} (relative, per step)")
                for x, y, lim in zip(with_mesh, without, spread):
                    d = max(abs(a - b) / abs(b) for a, b in zip(x, y))
                    check(d <= lim, f"{tag}: {x} against {y}, beyond the "
                          f"spread of two rules=None runs {lim}")
            log(f"{tag}: 2 steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens at full"
                f" width and depth (bf16 over fp32 master): (loss, grad norm) "
                f"{with_mesh} with the mesh, {without} without; bit for bit "
                f"equal: {with_mesh == without}"
                + ("" if spread is None else f" (held to rules=None's own "
                   f"spread {spread})")
                + f"; launches {runs[tag]}; 15a "
                f"{time.perf_counter() - t0:.1f} s")
        finally:
            dist.destroy_process_group()

        # 15b: two gloo ranks serve tensor-parallel on the one card
        t0 = time.perf_counter()
        mp.start_processes(phase15b_rank, args=(tmp,), nprocs=2,
                           start_method="spawn")
        wall = time.perf_counter() - t0
        reports = [json.load(open(f"{tmp}/rank{r}.json")) for r in range(2)]
        cfg = get_config(arch)
        tag = f"phase 15b serving {SERVE_MESH} mesh"
        check(all(r["staged"] for r in reports),
              f"{tag}: the gloo mesh on the card did not stage")
        n_norm = 2 * cfg.n_layers + 1
        for r in reports:
            steps = r["steps"]
            want = {"decode_attention": cfg.n_layers * steps,
                    "rmsnorm": n_norm * (1 + steps)}
            got = {k: r["counts"][k] for k in want}
            check(got == want and all(n == 0 for k, n in r["counts"].items()
                                      if k not in want),
                  f"{tag} rank {r['rank']}: launches {r['counts']} != {want}")
            runs[f"{tag} rank {r['rank']}"] = r["counts"]
            check(all(len(t) == MESH_NEW for t in r["tokens"]),
                  f"{tag} rank {r['rank']}: tokens {r['tokens']}")
            log(f"{tag} rank {r['rank']} (host-staged gloo): prefill "
                f"{r['prefill_ms']:.3f} ms, decode {r['decode_ms']:.3f} ms "
                f"over {steps} steps ({r['decode_ms'] / steps:.3f} ms a "
                f"step); peak device bytes {r['peak_bytes']} (parameter "
                f"blocks {r['param_bytes']}); staged collectives: prefill "
                f"{r['prefill_comms'][0]} calls {r['prefill_comms'][1]} "
                f"bytes, decode {r['decode_comms'][0] / steps:.1f} calls "
                f"{r['decode_comms'][1] / steps:.0f} bytes a step; launches "
                f"{got}; init {r['init_s']:.1f} s")
        check(reports[0]["tokens"] == reports[1]["tokens"],
              f"{tag}: the ranks' tokens differ")
        one = reports[0]["one_rank_tokens"]
        agree = sum(a == b for x, y in zip(reports[0]["tokens"], one)
                    for a, b in zip(x, y))
        log(f"{tag}: bf16 greedy tokens agreeing with the one-rank card run "
            f"{agree} of {sum(len(t) for t in one)} (reported, not gated: "
            f"bf16 routes cascade at depth); prompts "
            f"{reports[0]['prompt_lens']}; {wall:.1f} s wall with start-up")
        rel = reports[0]["gate_rel"]
        for r in reports:
            gate = r["gate_counts"]
            check(gate["decode_attention"] == GATE_LAYERS * MESH_NEW
                  and gate["rmsnorm"] == (2 * GATE_LAYERS + 1)
                  * (1 + MESH_NEW),
                  f"{tag} fp32 gate rank {r['rank']}: launches {gate}")
            runs[f"{tag} fp32 gate rank {r['rank']}"] = gate
        spread = reports[0]["gate_rel_kernels_off"]
        f64 = reports[0]["gate_rel_f64"]
        check(all(x <= 1e-3 for x in rel),
              f"{tag} fp32 gate: max |d logit| of the row's max {rel} "
              f"(limit 1e-3; one rank, kernels on against off: {spread})")
        check(max(f64["mesh"]) <= 2 * max(f64["one rank"]),
              f"{tag} fp32 gate: the mesh's logits {f64['mesh']} of the "
              f"row's max from the float64 compute, more than twice the "
              f"one-rank run's {f64['one rank']}")
        log(f"{tag} fp32 gate ({GATE_LAYERS} layers, full width, both "
            f"kernels, teacher-forced): prefill and {MESH_NEW} decode steps' "
            f"logits within {max(rel):.3e} of the row's max of the one-rank "
            f"card run (limit 1e-3, phase 9b's for two correct float32 "
            f"runs at this depth and width; here one rank with the kernels "
            f"on against off: {max(spread):.3e}); by row "
            f"{[float('%.3e' % x) for x in rel]}; against the float64 "
            f"compute the mesh within {max(f64['mesh']):.3e}, one rank "
            f"{max(f64['one rank']):.3e} (the mesh held to twice one "
            f"rank's); greedy tokens equal at every row: "
            f"{reports[0]['gate_tokens_equal']}")

        # 15c: four gloo ranks train on the one card
        t0 = time.perf_counter()
        mp.start_processes(phase15c_rank, args=(tmp,), nprocs=4,
                           start_method="spawn")
        wall = time.perf_counter() - t0
        reports = [json.load(open(f"{tmp}/rank{r}.json")) for r in range(4)]
    tag = f"phase 15c training {TRAIN_MESH} mesh"
    check(all(r["staged"] for r in reports),
          f"{tag}: the gloo mesh on the card did not stage")
    lead = reports[0]
    # each rank's blocks against the one-rank step's (the largest error
    # over the ranks), with 14b's limits but m's: a route may differ only
    # at a near tie (the mesh's choice gives up at most 1e-4 of the row's
    # largest router probability in the one-rank step), and the one-rank
    # step takes the mesh's routes, so the limits hold for the same
    # experts.  m (a gradient): 1e-2 of the leaf's max.  14b's 5e-3 is ~4
    # times one float32 run's error from float64 at its 1 x 512 tokens
    # (1.191e-3); at this batch, 2 x 512, one run's is 2.213e-3
    # (scripts/torch_mesh_conditioning.py --train, CPU), and the mesh's
    # forward rounds otherwise than one rank's (its tensor-parallel sums),
    # so the two part by up to about twice that.  The parameters: 1e-3 lr
    # where the update is not rounding noise, at a state's first step,
    # where AdamW's update is lr times the gradient's sign; at a later
    # step the update is m / sqrt(v), and m's error over a small m moves
    # it by far more, so there the blocks' update is held, bit for bit,
    # to AdamW of their own moments (the optimizer on blocks) and the
    # parameters' difference is reported.
    for i, row in enumerate(lead["steps"]):
        label = f"{tag} step {i + 1} ({row['kind']})"
        first = i == 0 or row["kind"] == "fsdp"
        err = {k: max(r["steps"][i]["err"][k] for r in reports)
               for k in ("m", "v", "params")}
        scalars = all(r["steps"][i]["err"]["scalars_equal"] for r in reports)
        update = all(r["steps"][i]["update_equal"] for r in reports)
        for r in reports:
            check(all(n == 0 for n in r["steps"][i]["counts"].values()),
                  f"{label} rank {r['rank']}: launches "
                  f"{r['steps'][i]['counts']} (training has no kernel)")
            runs[f"{label} rank {r['rank']}"] = r["steps"][i]["counts"]
        rl = abs(row["loss"] - row["ref_loss"]) / abs(row["ref_loss"])
        rg = abs(row["grad_norm"] - row["ref_grad_norm"]) \
            / abs(row["ref_grad_norm"])
        log(f"{label}: {row['ms']:.1f} ms (host-staged gloo, rank 0); loss "
            f"{row['loss']:.6f} / one rank {row['ref_loss']:.6f} (rel "
            f"{rl:.3e}), grad norm {row['grad_norm']:.6f} / "
            f"{row['ref_grad_norm']:.6f} (rel {rg:.3e}); routes differing "
            f"{row['route_flips']} of {row['routes']} (largest gap "
            f"{row['route_gap']:.3e} of the row's max probability); m "
            f"{err['m']:.3e}, v {err['v']:.3e} of the leaf's max, params "
            f"{err['params']:.3e} lr (lr {row['lr']:.3e}"
            + ("" if first else ", reported") + f"); every block's update "
            f"AdamW of its own moments bit for bit: {update}; step and data "
            f"cursor equal: {scalars}")
        check(row["route_gap"] <= 1e-4, f"{label}: {row['route_flips']} "
              f"MoE routes differ from the one-rank step's, giving up "
              f"{row['route_gap']} of the row's router probability (limit "
              "1e-4: a near tie)")
        check(rl <= 1e-5 and rg <= 5e-4, f"{label}: loss rel {rl}, grad "
              f"norm rel {rg} (limits 1e-5, 5e-4)")
        check(err["m"] <= 1e-2 and err["v"] <= 1e-2 and scalars and update
              and (err["params"] <= 1e-3 or not first),
              f"{label}: {err}, scalars {scalars}, update {update} (limits m "
              "1e-2, v 1e-2, params 1e-3 lr at a first step)")
    for r in reports:
        check(r["ckpt_equal"] and r["ckpt_step"] == len(MESH_STEPS),
              f"{tag} rank {r['rank']}: the 4-rank checkpoint, restored, "
              "differs from the live blocks")
    log(f"{tag}: {GATE_LAYERS} layers at full width, fp32, "
        f"{MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ} tokens a step, steps "
        f"{list(MESH_STEPS)} and an fsdp step from a fresh state; each "
        f"held against the one-rank card step from the same state on the "
        f"mesh's routes (14b's limits, m 1e-2); a checkpoint saved by the 4 "
        f"ranks "
        f"({lead['save_s']:.1f} s) restored whole on every rank "
        f"({lead['restore_s']:.1f} s on rank 0) equal byte for byte, block "
        f"for block, to the live state ({lead['ckpt_leaves']} leaves); "
        f"{wall:.1f} s wall with start-up")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return runs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA card")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        raise SmokeFailure(f"{SRC / 'repro_torch'} not found: run "
                           "chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import copy
    import dataclasses

    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core import (BatchMiner, NOACMiner, dense_tensor,
                                  exact_density_dense, fibers)
    from repro_torch.core import keys as K
    from repro_torch.core import reference as R
    from repro_torch.core import pipeline as P
    from repro_torch.core import radix as RX
    from repro_torch.data import synthetic as S
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import radix_sort as KR
    from repro_torch.kernels import segment_reduce as KS
    from repro_torch.kernels import signature as KSig
    from repro_torch.kernels import tricluster_density as KTD
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import rmsnorm as KN
    from repro_torch.launch import tricluster
    from repro_torch.serve import ServeEngine
    from repro_torch.models.api import get_model
    from repro_torch.models.telemetry import (collect_moe_routing,
                                              routing_context)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s wall for "
        f"{len(report)} libraries")
    for name, r in report.items():
        log(f"  {name}: built={r['built']} nvcc {r['seconds']:.2f} s")
        for line in r["log"].splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                log(f"    {line.strip()}")

    # -- data (set-up) -----------------------------------------------------
    t0 = time.perf_counter()
    bib = S.bibsonomy_like()
    ml = S.movielens_like(n_tuples=ML_T).deduplicated()
    check(bib.num_tuples == BIB_T, f"bibsonomy T={bib.num_tuples}")
    log(f"data: bibsonomy {bib.sizes} T={bib.num_tuples}; movielens "
        f"{ml.sizes} T={ml.num_tuples} ({time.perf_counter() - t0:.2f} s)")

    # -- phase 2: kernels against their plain versions ---------------------
    T = bib.num_tuples
    tup = torch.from_numpy(bib.tuples).to(dev)
    plan0 = K.plan_context_keys(bib.sizes, with_values=False)[0]
    words2 = plan0.pack_device(tup)                       # 44 bits, 2 words
    rplan2 = RX.plan_radix(plan0.total_bits, T, RX.HIST_DIGIT_BITS)
    ml_vals = torch.from_numpy(ml.values).to(dev)
    dom = torch.from_numpy(K.value_domain_host(ml.values)).to(dev)
    ml_plan0 = K.plan_context_keys(ml.sizes, True, dom.shape[0])[0]
    words1 = ml_plan0.pack_device(torch.from_numpy(ml.tuples).to(dev),
                                  ml_vals, dom)           # 31 bits, 1 word
    rplan1 = RX.plan_radix(ml_plan0.total_bits, ml.num_tuples,
                           RX.HIST_DIGIT_BITS)
    rng = np.random.default_rng(2026)
    sig = [torch.from_numpy(rng.integers(0, 2**32, T, dtype=np.uint32)
                            .view(np.int32)).to(dev) for _ in range(2)]
    rplan64 = RX.plan_radix(64, T, RX.HIST_DIGIT_BITS)
    check((rplan2.passes, rplan1.passes, rplan64.passes) == (6, 4, 8),
          f"radix passes {rplan2.passes}/{rplan1.passes}/{rplan64.passes}")

    # Stage-2 inputs of mode 0 as the path makes them
    sm = P.sort_mode(tup, 0, plan=plan0, sort_backend="lax",
                     use_kernels=False)
    vecs = P.hash_vectors_from_numpy(P.mode_hash_vectors(bib.sizes), dev)
    w_lo = vecs[0][0][sm.sorted_e].contiguous()
    w_hi = vecs[1][0][sm.sorted_e].contiguous()
    first = sm.first_occ.contiguous()
    ones = torch.full((T,), -1, dtype=torch.int32, device=dev)  # 0xFFFFFFFF
    all_first = torch.ones((T,), dtype=torch.bool, device=dev)

    kernels = []
    errs = {}

    def entry(name, source, replaces, kernel, plain, library, nbytes, nops,
              shape, plain_iters=20, ops_per_s=ALU_OPS_PER_S, iters=20,
              warm=3):
        """One kernel's line of the JSON: kernel, plain version and (where
        one PyTorch call computes the same function) library times, and
        the bound.  ``library=None``: there is no such call."""
        k = measure(kernel, iters, warm)
        p = measure(plain, plain_iters, min(warm, plain_iters))
        lib = (measure(library) if library is not None
               else {"ms": None, "call_ms": None})
        b_ms, b_by = bound(nbytes, nops, ops_per_s)
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/kernels/csrc/{source}",
                    replaces=replaces, ms=k["ms"], plain_ms=p["ms"],
                    library_ms=lib["ms"], bound_ms=b_ms, bound_by=b_by,
                    ms_source=k["source"], call_ms=k["call_ms"],
                    plain_ms_source=p["source"],
                    plain_call_ms=p["call_ms"],
                    library_call_ms=lib["call_ms"], shape=shape)

    # segment_reduce
    err = 0
    for label, args in (("bibsonomy mode 0", (w_lo, w_hi, first)),
                        ("uint32 wraparound", (ones, ones, all_first))):
        got = KS.segment_reduce(*args)
        want = ref.segment_reduce_ref(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            e = max_abs_err(g, w)
            check(e == 0, f"segment_reduce {label}: max |err| {e}")
            err = max(err, e)
        log(f"phase 2 segment_reduce {label}: bit-equal")
    wrap = np.cumsum(np.full(T, 0xFFFFFFFF, np.uint64)).astype(np.uint32)
    got_wrap = KS.segment_reduce(ones, ones, all_first)[0]
    check(np.array_equal(got_wrap.cpu().numpy().view(np.uint32), wrap),
          "segment_reduce wraparound differs from numpy's mod-2^32 cumsum")
    # the (T + 1) entry the path launches (core.pipeline.masked_prefix),
    # and inputs off 16 bytes (the scalar-load path)
    w_lo1, w_hi1, first1 = (torch.cat([x[:1], x])[1:]
                            for x in (w_lo, w_hi, first))
    for label, args in (("exclusive (T + 1)", (w_lo, w_hi, first)),
                        ("views off 16 bytes", (w_lo1, w_hi1, first1))):
        got = KS.segment_reduce_exclusive(*args)
        want = P.masked_prefix(*args, use_kernels=False)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            e = max_abs_err(g, w)
            check(g.shape == w.shape and e == 0,
                  f"segment_reduce {label}: max |err| {e}")
            err = max(err, e)
        log(f"phase 2 segment_reduce {label}: bit-equal")
    errs["segment_reduce"] = err

    def seg_library():
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (torch.cumsum(torch.where(first, w_lo, zero), 0,
                             dtype=torch.int32),
                torch.cumsum(torch.where(first, w_hi, zero), 0,
                             dtype=torch.int32),
                torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32))

    kernels.append(entry(
        "segment_reduce", "segment_reduce.cu",
        "src/repro/kernels/segment_reduce.py:69",
        lambda: KS.segment_reduce(w_lo, w_hi, first),
        lambda: ref.segment_reduce_ref(w_lo, w_hi, first), seg_library,
        nbytes=21 * T, nops=3 * T, shape=f"T={T}"))
    kernels[-1]["scalar_ms"] = measure(
        lambda: KS.segment_reduce(w_lo1, w_hi1, first1))["ms"]
    cfg = KS.kernel_config()
    check(cfg["local_bytes"] == 0, f"segment_reduce spills: {cfg}")
    kernels[-1]["registers"] = cfg["registers"]

    # radix_histogram
    err = 0
    for label, w, rp in (("bibsonomy 2-word 44-bit", words2, rplan2),
                         ("movielens 1-word 31-bit", words1, rplan1),
                         ("signature 64-bit", sig, rplan64)):
        got = KR.radix_histogram(w, rp.shifts, rp.widths)
        want = ref.radix_histogram_ref(w, rp.shifts, rp.widths)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0, f"radix_histogram {label}: max |err| {e}")
        check(int(got.sum()) == w[0].shape[0] * rp.passes,
              f"radix_histogram {label}: counts do not sum to T x passes")
        err = max(err, e)
        log(f"phase 2 radix_histogram {label}: bit-equal")
    same = [torch.full_like(w, 0x1234567) for w in sig]
    sig1 = [torch.cat([w[:1], w])[1:] for w in sig]
    check(KR.hist_plan_for(sig1).path == "scalar",
          "radix_histogram: views off 16 bytes planned for vector loads")
    for label, w, rp in (("all keys equal", same, rplan64),
                         ("views off 16 bytes", sig1, rplan64),
                         ("T mod 4 = 3", [x[:T - 2] for x in words2],
                          rplan2)):
        got = KR.radix_histogram(w, rp.shifts, rp.widths)
        e = max_abs_err(got, ref.radix_histogram_ref(w, rp.shifts,
                                                     rp.widths))
        check(e == 0, f"radix_histogram {label}: max |err| {e}")
        err = max(err, e)
        log(f"phase 2 radix_histogram {label}: bit-equal")
    errs["radix_histogram"] = err

    def hist_library():
        return [torch.bincount(RX.extract_digit(words2, s, wd),
                               minlength=RX.HIST_BUCKETS)
                for s, wd in zip(rplan2.shifts, rplan2.widths)]

    kernels.append(entry(
        "radix_histogram", "radix_sort.cu",
        "src/repro/kernels/radix_sort.py:93",
        lambda: KR.radix_histogram(words2, rplan2.shifts, rplan2.widths),
        lambda: ref.radix_histogram_ref(words2, rplan2.shifts,
                                        rplan2.widths), hist_library,
        nbytes=4 * 2 * T + 4 * 256 * rplan2.passes,
        nops=3 * T * rplan2.passes,
        shape=f"T={T} words=2 passes={rplan2.passes} (BibSonomy mode 0, "
              "the context's order)"))
    # the same on uniform 64-bit signature words (8 passes), and the
    # designs the kernel's increment was chosen from
    uni = entry(
        "radix_histogram", "radix_sort.cu", "",
        lambda: KR.radix_histogram(sig, rplan64.shifts, rplan64.widths),
        lambda: ref.radix_histogram_ref(sig, rplan64.shifts,
                                        rplan64.widths),
        lambda: [torch.bincount(RX.extract_digit(sig, s, wd),
                                minlength=RX.HIST_BUCKETS)
                 for s, wd in zip(rplan64.shifts, rplan64.widths)],
        nbytes=4 * 2 * T + 4 * 256 * rplan64.passes,
        nops=3 * T * rplan64.passes, shape="", plain_iters=4)
    from repro_torch.kernels import probe_radix_histogram as PH
    designs = PH.time_designs(
        {"skewed": (words2, rplan2.shifts, rplan2.widths),
         "uniform": (sig, rplan64.shifts, rplan64.widths)},
        names=PH.RIVAL_DESIGNS)
    check(all(d["bit_equal"] for d in designs.values()),
          "radix_histogram: a design differs from the plain version")
    kernels[-1].update(
        uniform_ms=uni["ms"], uniform_call_ms=uni["call_ms"],
        uniform_plain_ms=uni["plain_ms"],
        uniform_library_ms=uni["library_ms"],
        uniform_bound_ms=uni["bound_ms"],
        uniform_shape=f"T={T} words=2 passes={rplan64.passes} (random "
                      "signature words)",
        scalar_ms=measure(lambda: KR.radix_histogram(
            sig1, rplan64.shifts, rplan64.widths))["ms"],
        designs={k: d["ms"] for k, d in designs.items()})
    for k, d in designs.items():
        log(f"phase 2 radix_histogram design {k}: " + ", ".join(
            f"{lab} {ms:.5f} ms" for lab, ms in d["ms"].items()))
    log(f"phase 2 radix_histogram uniform 64-bit words: kernel "
        f"{uni['ms']:.5f} ms ({uni['call_ms']:.5f} ms per call), plain "
        f"{uni['plain_ms']:.5f} ms, bincount x8 {uni['library_ms']:.5f} "
        f"ms, bound {uni['bound_ms'] * 1e3:.3f} us")
    for vec in (True, False):
        for nw in (1, 2):
            cfg = KR.hist_kernel_config(vec, nw)
            check(cfg["local_bytes"] == 0,
                  f"radix_histogram spills: {vec} {nw} {cfg}")
    kernels[-1]["registers"] = KR.hist_kernel_config(True, 2)["registers"]

    # radix_rank
    hist2 = ref.radix_histogram_ref(words2, rplan2.shifts, rplan2.widths)
    starts2 = (torch.cumsum(hist2, 1, dtype=torch.int32) - hist2)
    dig_lo = RX.extract_digit(words2, rplan2.shifts[0], rplan2.widths[0])
    dig_top = RX.extract_digit(words2, rplan2.shifts[-1], rplan2.widths[-1])
    dig_rand = torch.from_numpy(rng.integers(0, 256, T).astype(np.int32)
                                ).to(dev)
    rand_hist = torch.bincount(dig_rand, minlength=256).to(torch.int32)
    rand_starts = torch.cumsum(rand_hist, 0, dtype=torch.int32) - rand_hist
    err = 0
    for label, d, st in (("bibsonomy pass 0", dig_lo, starts2[0]),
                         ("bibsonomy top pass", dig_top, starts2[-1]),
                         ("uniform digits", dig_rand, rand_starts)):
        st = st.contiguous()
        got = KR.radix_rank(d, st)
        want = ref.radix_rank_ref(d, st)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        check(e == 0, f"radix_rank {label}: max |err| {e}")
        check(torch.equal(torch.sort(got).values,
                          torch.arange(T, dtype=torch.int32, device=dev)),
              f"radix_rank {label}: ranks are not a permutation")
        err = max(err, e)
        log(f"phase 2 radix_rank {label}: bit-equal")
    st0 = starts2[0].contiguous()
    iota = torch.arange(T, dtype=torch.int32, device=dev)
    # the rank sweep's edge cases: one digit for every element (the
    # longest look-back chains on one digit), 90% of one digit, and the
    # ragged ends of one and two tiles
    rank_cases = [("all digits equal", torch.full_like(dig_lo, 200)),
                  ("90% one digit", torch.where(
                      torch.from_numpy(rng.random(T) < 0.9).to(dev),
                      torch.full_like(dig_rand, 7), dig_rand))]
    rank_cases += [(f"T = {n}", dig_rand[:n].contiguous()) for n in (
        KR.RANK_TILE - 1, KR.RANK_TILE + 1, 2 * KR.RANK_TILE - 1,
        2 * KR.RANK_TILE + 1)]
    for label, d in rank_cases:
        h = torch.bincount(d, minlength=256).to(torch.int32)
        st = torch.cumsum(h, 0, dtype=torch.int32) - h
        got = KR.radix_rank(d, st)
        torch.cuda.synchronize()
        e = max_abs_err(got, ref.radix_rank_ref(d, st))
        check(e == 0, f"radix_rank {label}: max |err| {e}")
        log(f"phase 2 radix_rank {label}: bit-equal")

    def rank_library():
        order = torch.sort(dig_lo, stable=True).indices
        out = torch.empty_like(iota)
        out[order] = iota
        return out

    check(torch.equal(rank_library(), KR.radix_rank(dig_lo, st0)),
          "radix_rank: stable torch.sort ranks differ")
    kernels.append(entry(
        "radix_rank", "radix_sort.cu", "src/repro/kernels/radix_sort.py:133",
        lambda: KR.radix_rank(dig_lo, st0),
        lambda: ref.radix_rank_ref(dig_lo, st0), rank_library,
        nbytes=4 * T + 4 * 256 + 4 * T, nops=4 * T,
        shape=f"T={T} (rank-only entry)", plain_iters=4))

    # the fused pass (what the main path launches): each plan's passes in
    # turn, bit for bit against the plain pass, which also gives the next
    # pass's inputs; then pass 1 of the BibSonomy key (2 words and a
    # payload in, the same out) timed beside its plain version, the
    # per-pass sequence it replaced (digit, gather, rank, scatter,
    # compose, with the rank-only kernel) and stable torch.sort + gathers
    for label, w, rp in (("bibsonomy 2-word 44-bit", words2, rplan2),
                         ("movielens 1-word 31-bit", words1, rplan1),
                         ("signature 64-bit", sig, rplan64)):
        h = ref.radix_histogram_ref(w, rp.shifts, rp.widths)
        sts = torch.cumsum(h, 1, dtype=torch.int32) - h
        cur, perm = tuple(w), None
        for p, (sh, wd) in enumerate(zip(rp.shifts, rp.widths)):
            got_w, got_p = KR.radix_pass(cur, perm, sh, wd, sts[p])
            want_w, want_p = ref.radix_pass_ref(cur, perm, sh, wd, sts[p])
            torch.cuda.synchronize()
            e = max(max_abs_err(got_p, want_p), *(
                max_abs_err(a, b) for a, b in zip(got_w, want_w)))
            check(e == 0, f"radix_pass {label} pass {p}: max |err| {e}")
            err = max(err, e)
            cur, perm = want_w, want_p
        want = torch.sort(K.word_key(w), stable=True).indices
        check(torch.equal(perm.long(), want),
              f"radix_pass {label}: passes differ from stable torch.sort")
        log(f"phase 2 radix_pass {label}: {rp.passes} passes bit-equal, "
            "the stable sort")
    errs["radix_rank"] = err
    w_p1, perm_p1 = ref.radix_pass_ref(words2, None, rplan2.shifts[0],
                                       rplan2.widths[0], starts2[0])
    sh1, wd1, st1 = rplan2.shifts[1], rplan2.widths[1], starts2[1]

    def old_pass():
        dig = RX.extract_digit(words2, sh1, wd1)[perm_p1]
        rank = KR.radix_rank(dig, st1)
        src = torch.empty_like(iota)
        src[rank] = iota
        return perm_p1[src]

    def pass_library():
        order = torch.sort(RX.extract_digit(w_p1, sh1, wd1),
                           stable=True).indices
        return tuple(x[order] for x in w_p1), perm_p1[order]

    check(torch.equal(old_pass(), KR.radix_pass(w_p1, perm_p1, sh1, wd1,
                                                st1)[1]),
          "radix_pass: the per-pass sequence gives another permutation")
    fused = entry(
        "radix_pass", "radix_sort.cu", "",
        lambda: KR.radix_pass(w_p1, perm_p1, sh1, wd1, st1),
        lambda: ref.radix_pass_ref(w_p1, perm_p1, sh1, wd1, st1),
        pass_library, nbytes=2 * 12 * T + 4 * 256, nops=8 * T,
        shape=f"T={T} words=2 with payload", plain_iters=4)
    seq = measure(old_pass)
    kernels[-1].update(
        fused_pass_ms=fused["ms"], fused_pass_plain_ms=fused["plain_ms"],
        fused_pass_library_ms=fused["library_ms"],
        fused_pass_bound_ms=fused["bound_ms"],
        fused_pass_shape=fused["shape"], per_pass_sequence_ms=seq["ms"])
    log(f"phase 2 radix_rank fused pass: kernel {fused['ms']:.5f} ms "
        f"({fused['ms_source']}), plain {fused['plain_ms']:.5f} ms, the "
        f"per-pass sequence it replaced {seq['ms']:.5f} ms, stable sort + "
        f"gathers {fused['library_ms']:.5f} ms, bound "
        f"{fused['bound_ms'] * 1e3:.3f} us ({fused['bound_by']})")
    usage = {}
    for r in report.values():
        usage.update(ptxas_usage(r["log"]))
    for name, u in sorted(usage.items()):
        if name.startswith(("radix_rank_onesweep", "rmsnorm_vec",
                            "radix_hist_kernel", "sr_onesweep")):
            log(f"phase 2 ptxas {name}: {u}")
    # flash_attention
    def fa_inputs(shape, dtype, seed):
        b, hq, hkv, sq, skv, d = shape
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(s, generator=g, device=dev).to(dtype)
                for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]

    full = (4, 24, 8, 2048, 2048, 64)     # granite-moe-3b-a800m attention
    bf16, fp32 = torch.bfloat16, torch.float32
    fa_cases = [
        ("full width causal bf16", full, bf16, dict(causal=True)),
        ("full width causal fp32", full, fp32, dict(causal=True)),
        ("D 128 GQA group 2 bf16", (2, 16, 8, 1024, 1024, 128), bf16,
         dict(causal=True)),
        ("D 128 GQA group 2 fp32", (2, 16, 8, 1024, 1024, 128), fp32,
         dict(causal=True)),
        ("causal window 512 bf16", full, bf16, dict(causal=True,
                                                    window=512)),
        ("non-causal window 512 fp32", full, fp32, dict(causal=False,
                                                         window=512)),
        ("q_offset = Skv - Sq fp32", (4, 24, 8, 512, 2048, 64), fp32,
         dict(causal=True, q_offset=2048 - 512)),
        ("ragged S 200 fp32", (2, 24, 8, 200, 200, 64), fp32,
         dict(causal=True)),
        ("ragged S 200 bf16", (2, 24, 8, 200, 200, 64), bf16,
         dict(causal=True)),
        ("D 16 S 100 bf16", (2, 8, 2, 100, 100, 16), bf16,
         dict(causal=True)),
        ("D 32 Sq 190 Skv 300 bf16", (2, 8, 4, 190, 300, 32), bf16,
         dict(causal=True)),
        ("D 64 S 257 window 100 bf16", (2, 24, 8, 257, 257, 64), bf16,
         dict(causal=True, window=100)),
        ("D 128 S 65 non-causal bf16", (2, 16, 8, 65, 65, 128), bf16,
         dict(causal=False)),
    ]
    fa_errs = {}
    for i, (label, shape, dtype, kw) in enumerate(fa_cases):
        q, k, v = fa_inputs(shape, dtype, 100 + i)
        got = KF.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        check(got.dtype == dtype and got.shape == want.shape,
              f"flash_attention {label}: {got.dtype} {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()),
              f"flash_attention {label}: non-finite output")
        if dtype == fp32:
            check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
                  f"flash_attention {label}: max |err| {e} beyond atol "
                  "2e-5 + rtol 2e-5")
            gate = "atol 2e-5 + rtol 2e-5 against the plain version"
        else:
            # P enters the tensor cores as bf16: each output against a
            # float64 evaluation on the same inputs (ref.flash_bf16_gate)
            ratio = ref.flash_bf16_gate(got, q, k, v, **kw)
            check(ratio <= 1.0,
                  f"flash_attention {label}: {ratio:.3f} of the float64 "
                  "gate 2**-7 (|o64| + P64 |V| / l64) + 1e-5")
            gate = (f"{ratio:.3f} of the float64 gate 2**-7 (|o64| + "
                    "P64 |V| / l64) + 1e-5")
        fa_errs[label] = e
        log(f"phase 2 flash_attention {label} {shape}: max |err| against "
            f"the plain version {e:.3e}; {gate}")
    errs["flash_attention"] = fa_errs["full width causal bf16"]
    del q, k, v, got, want
    q, k, v = fa_inputs(full, bf16, 100)
    b_, hq_, _, s_, _, d_ = full
    pairs = s_ * (s_ + 1) // 2             # causal (q, k) pairs per head
    kernels.append(entry(
        "flash_attention", "flash_attention.cu",
        "src/repro/kernels/flash_attention.py:102",
        lambda: KF.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True),
        nbytes=sum(x.numel() * x.element_size() for x in (q, k, v, q)),
        nops=4 * b_ * hq_ * pairs * d_, shape=f"B={b_} Hq={hq_} Hkv=8 "
        f"S={s_} D={d_} causal bf16", plain_iters=3,
        ops_per_s=BF16_TENSOR_OPS_PER_S))
    kernels[-1]["max_abs_err_by_case"] = fa_errs
    del q, k, v

    # signature and tricluster_density at the JAX package's test shapes
    # (tests/test_kernels.py), bit for bit; tricluster_density also where
    # M % 16 != 0 (Y by byte loads) and B > 128 (a tile's b range wraps);
    # timed at full size in phase 8
    sig_err = 0
    for t_, e_ in ((8, 128), (16, 512), (256, 1024), (3, 77)):
        m_ = torch.from_numpy(rng.integers(0, 2, (t_, e_))).to(dev,
                                                                torch.uint8)
        r_ = torch.from_numpy(rng.integers(1, 2**32, e_, dtype=np.uint32)
                              .view(np.int32)).to(dev)
        for label, mm in (("uint8", m_), ("bool", m_.bool())):
            e = max_abs_err(KSig.signature(mm, r_), ref.signature_ref(mm, r_))
            check(e == 0, f"signature ({t_}, {e_}) {label}: max |err| {e}")
            sig_err = max(sig_err, e)
        log(f"phase 2 signature ({t_}, {e_}): bit-equal (uint8 and bool)")
    r_wrap = torch.full((1000,), -1, dtype=torch.int32, device=dev)
    m_wrap = torch.ones((7, 1000), dtype=torch.bool, device=dev)
    got = KSig.signature(m_wrap, r_wrap)
    check(max_abs_err(got, ref.signature_ref(m_wrap, r_wrap)) == 0 and
          int(got[0].item()) & 0xFFFFFFFF == (1000 * 0xFFFFFFFF) % 2**32,
          "signature uint32 wraparound")
    log("phase 2 signature uint32 wraparound: bit-equal, mod 2^32")
    errs["signature"] = sig_err
    td_err = 0.0
    for g_, m_n, b_, t_ in ((8, 16, 16, 8), (16, 8, 32, 128), (7, 5, 9, 3),
                            (9, 50, 4, 40), (3, 40, 150, 17)):
        args = [torch.from_numpy(rng.integers(0, 2, s_)).to(dev, torch.bool)
                for s_ in ((g_, m_n, b_), (t_, g_), (t_, m_n), (t_, b_))]
        got = KTD.tricluster_density(*args)
        want = ref.tricluster_density_ref(*args)
        torch.cuda.synchronize()
        td_err = max(td_err, float((got - want).abs().max()))
        check(torch.equal(got, want),
              f"tricluster_density {(g_, m_n, b_, t_)}: differs")
        log(f"phase 2 tricluster_density (G, M, B, T) = "
            f"{(g_, m_n, b_, t_)}: bit-equal")
    errs["tricluster_density"] = td_err

    for k in kernels:
        log(f"phase 2 {k['name']}: kernel {k['ms']:.5f} ms "
            f"({k['ms_source']}; {k['call_ms']:.5f} ms per call), plain "
            f"{k['plain_ms']:.5f} ms, library {k['library_ms']:.5f} ms, "
            f"bound {k['bound_ms'] * 1e3:.3f} us ({k['bound_by']})")

    # -- phases 3 and 4: the main path --------------------------------------
    def expected_launches(sizes, with_values, value_slots):
        plans = K.plan_context_keys(sizes, with_values, value_slots)
        n = len(sizes)
        return {"radix_histogram": n + 1,
                "radix_rank": n * math.ceil(plans[0].total_bits / 8) + 8,
                "segment_reduce": n}

    def drive(label, miner, lax_miner, args, expect):
        miner(*args).keep.cpu()                     # first (cold) run
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = miner(*args)
        res.keep.cpu()
        warm_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        log(f"{label}: launches {counts} (expected {expect})")
        path = {k: counts[k] for k in ops.PATH_KERNELS["mining"]}
        check(all(n > 0 for n in path.values()),
              f"{label}: a kernel of the path was not launched: {counts}")
        check(path == expect, f"{label}: launches {path} != {expect}")
        check(all(n == 0 for k, n in counts.items() if k not in path),
              f"{label}: a kernel of another path was launched: {counts}")
        times = [warm_ms]
        for _ in range(2):
            t0 = time.perf_counter()
            miner(*args).keep.cpu()
            times.append((time.perf_counter() - t0) * 1e3)
        n_t = args[0].shape[0]
        kept = int(res.keep.sum())
        check(bool(torch.isfinite(res.density).all()),
              f"{label}: non-finite density")
        check(res.perms.shape == (len(miner.sizes), n_t),
              f"{label}: perms shape {tuple(res.perms.shape)}")
        check(kept > 0, f"{label}: no cluster kept")
        leaves_equal(res, lax_miner(*args), f"{label} radix vs lax")
        log(f"{label}: warm ms {times} (min {min(times):.3f}); "
            f"{n_t / (min(times) / 1e3):.0f} tuples/s; kept clusters "
            f"{kept}; all leaves equal to sort_backend='lax' on the card")
        busy, by_name, _, complete = device_ms(
            lambda: miner(*args).keep.cpu(), iters=3)
        if busy is not None:
            log(f"{label}: " + (
                f"device busy {busy:.3f} ms of the fastest warm "
                f"{min(times):.3f} ms (idle share "
                f"{1 - busy / min(times):.3f})" if complete else
                "device busy and idle share not measured (profiler trace "
                "incomplete)") + f"; {len(by_name)} device activity kinds "
                "traced, the largest:")
            for kname, kms in sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:8]:
                log(f"    {kms:.4f} ms  {kname[:90]}")
        return counts, min(times), kept

    # phase 3: batch prime on full-size BibSonomy
    expect = expected_launches(bib.sizes, False, None)
    check(expect == {"radix_histogram": 4, "radix_rank": 26,
                     "segment_reduce": 3}, f"bibsonomy plan {expect}")
    prime_counts, prime_ms, prime_kept = drive(
        "phase 3 batch prime bibsonomy",
        BatchMiner(bib.sizes, device="cuda"),
        BatchMiner(bib.sizes, sort_backend="lax", device="cuda"),
        (bib.tuples,), expect)
    imdb = S.imdb_like()
    leaves_equal(BatchMiner(imdb.sizes, device="cuda")(imdb.tuples),
                 BatchMiner(imdb.sizes, device="cpu")(imdb.tuples),
                 "imdb prime cuda vs cpu")
    log("phase 3 imdb prime: CUDA result equals the CPU (plain) result")

    # phase 4: batch NOAC on the MovieLens-1M shape
    expect = expected_launches(ml.sizes, True, dom.shape[0])
    check(expect == {"radix_histogram": 4, "radix_rank": 20,
                     "segment_reduce": 3}, f"movielens plan {expect}")
    noac_counts, noac_ms, noac_kept = drive(
        "phase 4 batch noac movielens",
        NOACMiner(ml.sizes, delta=1.0, device="cuda"),
        NOACMiner(ml.sizes, delta=1.0, sort_backend="lax", device="cuda"),
        (ml.tuples, ml.values), expect)
    mls = S.movielens_like(n_tuples=20_000, seed=1).deduplicated()
    leaves_equal(
        NOACMiner(mls.sizes, delta=1.0, device="cuda")(mls.tuples,
                                                         mls.values),
        NOACMiner(mls.sizes, delta=1.0, device="cpu")(mls.tuples,
                                                        mls.values),
        "movielens-20k noac cuda vs cpu")
    log("phase 4 movielens-20k noac: CUDA result equals the CPU result")

    # -- phase 5: the CLI twin ---------------------------------------------
    def cli_clusters(backend, *extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tricluster.main(["--dataset", "imdb", "--backend", backend,
                                  "--device", "cuda", "--print-top", "1",
                                  *extra])
        out = buf.getvalue()
        print(out, end="", flush=True)
        check(rc == 0, f"CLI --dataset imdb --backend {backend}: rc={rc}")
        line = [ln for ln in out.splitlines() if "unique clusters" in ln]
        check(len(line) == 1, f"CLI --backend {backend}: no cluster count")
        return int(line[0].split(":")[1].split()[0])

    n_batch, n_ref = cli_clusters("batch"), cli_clusters("reference")
    check(n_batch == n_ref, f"CLI cluster counts: batch {n_batch}, "
          f"reference {n_ref}")
    n_dist = cli_clusters("distributed", "--strategy", "shuffle")
    check(n_dist == n_batch, f"CLI cluster counts: batch {n_batch}, "
          f"distributed/shuffle {n_dist}")
    rc = tricluster.main(["--dataset", "imdb", "--backend", "spark",
                          "--device", "cuda"])
    check(rc == 2, f"CLI --backend spark: rc={rc}, expected 2")
    log(f"phase 5 CLI: rc=0 for batch, reference and distributed/shuffle "
        f"({n_batch} clusters each), rc=2 for an unknown backend")

    # -- phase 6: MoE routing telemetry at full width ------------------------
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              attn_impl="pallas")
    check(cfg.n_params() == GRANITE_PARAMS,
          f"granite-moe parameters {cfg.n_params()}")
    t0 = time.perf_counter()
    params = get_model(cfg).init(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    check(sum(p.numel() for p in params.parameters()) == GRANITE_PARAMS,
          "granite-moe parameter tree size")
    log(f"phase 6 init {cfg.name}: {GRANITE_PARAMS} parameters fp32 on the "
        f"card in {time.perf_counter() - t0:.2f} s (set-up)")
    tokens = TokenPipeline(cfg, 4, 2048, seed=0).batch_at(0)["tokens"]
    collect_moe_routing(cfg, params, tokens)             # first (cold) run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    routes = collect_moe_routing(cfg, params, tokens)
    t1 = time.perf_counter()
    ctx = routing_context(cfg, tokens, routes)
    t2 = time.perf_counter()
    miner = BatchMiner(ctx.sizes, theta=0.2, device="cuda")
    res = miner(ctx.tuples)
    res.keep.cpu()
    t3 = time.perf_counter()
    routing_counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    route_ms, ctx_ms, mine_ms = ((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                                 (t3 - t2) * 1e3)
    expect = expected_launches(ctx.sizes, False, None)
    log(f"phase 6 routing run: launches {routing_counts} (expected "
        f"flash_attention {cfg.n_layers}, mining {expect})")
    check(routing_counts["flash_attention"] == cfg.n_layers,
          f"flash_attention launched {routing_counts['flash_attention']} "
          f"times, expected {cfg.n_layers}")
    check({k: routing_counts[k] for k in ops.PATH_KERNELS["mining"]}
          == expect, f"routing mining launches {routing_counts}")
    check(routes.shape == (cfg.n_layers, 4, 2048, cfg.top_k)
          and routes.min() >= 0 and routes.max() < cfg.n_experts,
          f"routes {routes.shape} in [{routes.min()}, {routes.max()}]")
    kept = int(res.keep.sum())
    check(bool(torch.isfinite(res.density).all()), "routing: density")
    times, same = [route_ms], True
    for _ in range(2):
        t0 = time.perf_counter()
        again = collect_moe_routing(cfg, params, tokens)
        times.append((time.perf_counter() - t0) * 1e3)
        same &= bool(np.array_equal(again, routes))
    mine_times, ctx_times = [mine_ms], [ctx_ms]
    for _ in range(2):
        t0 = time.perf_counter()
        miner(ctx.tuples).keep.cpu()
        mine_times.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        routing_context(cfg, tokens, routes)
        ctx_times.append((time.perf_counter() - t0) * 1e3)
    route_ms, mine_ms = min(times), min(mine_times)
    log(f"phase 6 routing pass: warm ms {times} (min {route_ms:.3f}; "
        f"{4 * 2048 / (route_ms / 1e3):.0f} tokens/s); peak device memory "
        f"{peak_gb:.2f} GB; routing_context ms {ctx_times}; context "
        f"{ctx.sizes} |I| = {ctx.num_tuples} (density {ctx.density:.3e}); "
        f"mining warm ms {mine_times} (min {mine_ms:.3f}); "
        f"{int(res.is_unique.sum())} clusters, {kept} with density >= 0.2; "
        f"routes of the three warm passes identical: {same}")
    busy, by_name, by_op, complete = device_ms(
        lambda: collect_moe_routing(cfg, params, tokens), iters=2)
    route_busy = busy if complete else None
    if busy is not None:
        log("phase 6 routing pass: " + (
            f"device busy {busy:.3f} ms of the fastest warm {route_ms:.3f} "
            f"ms (idle share {1 - busy / route_ms:.3f})" if complete else
            "device busy and idle share not measured (profiler trace "
            "incomplete)") + "; the largest device activities traced:")
        for kname, kms in sorted(by_name.items(),
                                 key=lambda kv: -kv[1])[:16]:
            log(f"    {kms:.4f} ms  {kname[:90]}")
        log(f"phase 6 routing pass: device ms by the PyTorch op that "
            f"launched it, the largest (ops {sum(by_op.values()):.3f} ms of "
            f"the {busy:.3f} traced ms; the rest launched outside any op):")
        for oname, oms in sorted(by_op.items(), key=lambda kv: -kv[1])[:16]:
            log(f"    {oms:.4f} ms  {oname[:90]}")
    blocked = dataclasses.replace(cfg, attn_impl="blocked")
    share, per_layer = route_agreement(
        routes, collect_moe_routing(blocked, params, tokens))
    log(f"phase 6 routes agreeing with attn_impl='blocked' (bf16): "
        f"{share:.6f} of (layer, token, slot); per layer "
        f"{[round(x, 4) for x in per_layer]}")
    check(per_layer[0] >= 0.9,
          f"layer-0 routes agree with the plain attention only "
          f"{per_layer[0]:.4f}")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res_cpu = BatchMiner(ctx.sizes, theta=0.2, device="cpu")(ctx.tuples)
    leaves_equal(res, res_cpu, "routing context mining cuda vs cpu")
    log(f"phase 6 routing context mining: CUDA result equals the CPU result "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")

    # -- phase 7: the smoke routing passes in fp32, card against CPU ----------
    for arch in ("granite-moe-3b-a800m", "mixtral-8x7b"):
        scfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                   attn_impl="pallas")
        cpu_params = get_model(scfg).init(
            scfg, torch.Generator().manual_seed(0), device="cpu")
        card_params = copy.deepcopy(cpu_params).to(dev)
        stoks = TokenPipeline(scfg, 4, 64, seed=0).batch_at(0)["tokens"]
        before = KF.flash_attention.launches
        got = collect_moe_routing(scfg, card_params, stoks)
        check(KF.flash_attention.launches - before == scfg.n_layers,
              f"{scfg.name}: flash_attention launches")
        want = collect_moe_routing(scfg, cpu_params, stoks)
        check(np.array_equal(got, want),
              f"{scfg.name} fp32 routes on the card differ from the CPU's "
              f"(agreement {route_agreement(got, want)[0]:.6f})")
        log(f"phase 7 {scfg.name} fp32: routes through the kernel equal the "
            f"CPU plain run ({got.size} routes)")

    # -- phase 8: the dense validation path ----------------------------------
    def dense_path(miner, tup, sizes):
        """dense_tensor -> fibers -> per-mode, per-lane set signatures (the
        ``signature`` kernel), mixed -> exact densities (the
        ``tricluster_density`` kernel)."""
        tens = dense_tensor(tup, sizes)
        masks = fibers(tens, tup)
        sig = P.mix_signatures(
            [ops.set_signature(m, r) for m, r in zip(masks, miner._lo)],
            [ops.set_signature(m, r) for m, r in zip(masks, miner._hi)])
        return tens, masks, sig, exact_density_dense(tens, masks)

    dense_counts = {}

    def drive_dense(label, ctx, rows=None):
        """Mine ``ctx`` on the card and run the dense path over it (cold,
        then counted); check the signature identity, the cardinalities
        and the kernels against their plain versions (on the first
        ``rows`` tuples where given).  Returns the pieces for the checks
        that follow."""
        miner = BatchMiner(ctx.sizes, device="cuda")
        tup = torch.from_numpy(ctx.tuples).to(dev)
        miner(ctx.tuples).keep.cpu()                       # cold
        dense_path(miner, tup, ctx.sizes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = miner(ctx.tuples)
        tens, masks, (sig_lo, sig_hi), dens = dense_path(miner, tup,
                                                         ctx.sizes)
        torch.cuda.synchronize()
        path_ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        dense_counts[label] = counts
        n = len(ctx.sizes)
        log(f"{label}: launches {counts} (expected signature {2 * n}, "
            "tricluster_density 1, and the mining kernels)")
        check(all(counts[k] > 0 for k in ops.PATH_KERNELS["mining"]
                  + ops.PATH_KERNELS["dense"]),
              f"{label}: a kernel of the path was not launched: {counts}")
        check(counts["signature"] == 2 * n
              and counts["tricluster_density"] == 1
              and counts["flash_attention"] == 0,
              f"{label}: launches {counts}")
        check(torch.equal(sig_lo, res.sig_lo)
              and torch.equal(sig_hi, res.sig_hi),
              f"{label}: the fibers' signatures differ from the pipeline's "
              f"({int((sig_lo != res.sig_lo).sum())} lo, "
              f"{int((sig_hi != res.sig_hi).sum())} hi of "
              f"{sig_lo.shape[0]} tuples)")
        card = torch.stack([ref.row_counts(m).to(torch.int32) for m in masks])
        check(torch.equal(card, res.cardinalities),
              f"{label}: fiber sizes differ from the cardinalities")
        sel = slice(None) if rows is None else slice(0, rows)
        err = 0
        for k in range(n):
            for r in (miner._lo[k], miner._hi[k]):
                m_ = masks[k][sel]
                e = max_abs_err(KSig.signature(m_, r),
                                ref.signature_ref(m_, r))
                check(e == 0, f"{label}: signature mode {k}: max |err| {e}")
                err = max(err, e)
        errs["signature"] = max(errs["signature"], err)
        sub = [m[sel] for m in masks]
        num = KTD.tricluster_density(tens, *sub)
        num_plain = ref.tricluster_density_ref(tens, *sub)
        check(torch.equal(num, num_plain),
              f"{label}: tricluster_density differs from its plain version "
              f"(max |err| {float((num - num_plain).abs().max())})")
        if rows is None:
            check(torch.equal(dens, exact_density_dense(tens, masks,
                                                        use_kernels=False)),
                  f"{label}: exact_density_dense differs from its plain "
                  "version")
        log(f"{label}: T={ctx.num_tuples} sizes {ctx.sizes}; signatures "
            f"of every tuple equal the pipeline's sig_lo/sig_hi; fiber "
            f"sizes equal the cardinalities; both kernels bit-equal to "
            f"their plain versions"
            + ("" if rows is None else f" (tricluster_density on the first "
               f"{rows} rows)") + f"; path {path_ms:.3f} ms (first warm "
            f"run), peak device memory {peak_gb:.3f} GB")
        return miner, tup, res, tens, masks, num, dens

    def check_kept_against_reference(label, ctx, res, miner, num, dens):
        """Every kept cluster's exact numerator against
        ``core.reference.exact_density`` x volume, on the host."""
        t0 = time.perf_counter()
        idx = np.nonzero(res.keep.cpu().numpy())[0]
        clusters = miner.materialise(res)
        check(len(clusters) == len(idx), f"{label}: materialised clusters")
        num_h, dens_h = num.cpu().numpy(), dens.cpu().numpy()
        vol_h = res.volume.cpu().numpy()
        for i, (comps, _) in zip(idx, clusters):
            d_ref = R.exact_density(ctx, comps)
            check(round(d_ref * float(vol_h[i])) == num_h[i],
                  f"{label}: tuple {i}: numerator {num_h[i]} vs reference "
                  f"{d_ref * float(vol_h[i])}")
            check(abs(float(dens_h[i]) - d_ref) <= 1e-5 * d_ref,
                  f"{label}: tuple {i}: density {dens_h[i]} vs {d_ref}")
        log(f"{label}: {len(idx)} kept clusters: exact numerators equal "
            f"reference.exact_density x volume, densities within rel 1e-5 "
            f"({time.perf_counter() - t0:.1f} s on the host)")

    for label, ctx8 in (("phase 8 dense imdb", S.imdb_like()),
                        ("phase 8 dense k1", S.k1_dense_cube())):
        miner8, _, res8, tens8, masks8, num8, dens8 = drive_dense(label, ctx8)
        check_kept_against_reference(label, ctx8, res8, miner8, num8, dens8)
        del tens8, masks8

    # the MovieLens-1M shape, prime, at full size
    label = "phase 8 dense movielens"
    check(ml.num_tuples == 356_877, f"movielens T={ml.num_tuples}")
    ml_tup = torch.from_numpy(ml.tuples).to(dev)
    ml_tens = dense_tensor(ml_tup, ml.sizes)
    ml_masks = fibers(ml_tens, ml_tup)
    torch.cuda.synchronize()
    t_one = time.perf_counter()
    KTD.tricluster_density(ml_tens, *ml_masks)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t_one
    cut = t_one > 30.0
    td_rows = 65_536 if cut else ml.num_tuples
    log(f"{label}: one tricluster_density call at full T took {t_one:.3f} s"
        + (f" > 30 s: timed and compared on the first {td_rows} rows"
           if cut else ""))
    del ml_masks, ml_tens
    mlm, ml_tup, ml_res, ml_tens, ml_masks, ml_num, ml_dens = drive_dense(
        label, ml, rows=td_rows if cut else None)
    if not cut:
        check(bool((ml_num >= ml_res.gen_count.to(torch.float32)).all()),
              f"{label}: a numerator below the generating-tuple count")
        log(f"{label}: every numerator >= gen_count; "
            f"{int(ml_res.is_unique.sum())} unique clusters")
    # the dense work a sparse path over light rows would skip: pairs (g, b)
    # with X[t,g] Z[t,b] = 1, against the dense G*B of every row
    card8 = [ref.row_counts(m_).to(torch.float64) for m_ in ml_masks]
    xz_pairs = float((card8[0] * card8[2]).sum())
    log(f"{label}: mean |X_t|, |Y_t|, |Z_t| "
        f"{', '.join(f'{float(c.mean()):.1f}' for c in card8)}; "
        f"sum |X_t| |Z_t| = {xz_pairs:.4g} (g, b) pairs against T G B = "
        f"{ml.num_tuples * ml.sizes[0] * ml.sizes[2]:.4g}")
    del card8
    path_times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense_path(mlm, ml_tup, ml.sizes)
        torch.cuda.synchronize()
        path_times.append((time.perf_counter() - t0) * 1e3)
    T8 = ml.num_tuples
    G8, M8, B8 = ml.sizes
    sig_bytes_all = 2 * sum(T8 * n + 4 * n + 4 * T8 for n in ml.sizes)
    sig_all_ms = time_ms(lambda: [ops.set_signature(m, r)
                                  for lane in (mlm._lo, mlm._hi)
                                  for m, r in zip(ml_masks, lane)],
                         iters=5, warm=1)
    sig_all_bound = sig_bytes_all / HBM_BYTES_PER_S * 1e3
    log(f"{label}: dense path (dense_tensor, fibers, 6 signatures, "
        f"exact_density_dense) warm ms {[round(x, 3) for x in path_times]} "
        f"(min {min(path_times):.3f}); the 6 signature launches "
        f"{sig_all_ms:.5f} ms against a {sig_all_bound:.5f} ms bound "
        f"({sig_bytes_all} bytes)")
    m0, r0 = ml_masks[0], mlm._lo[0]
    kernels.append(entry(
        "signature", "signature.cu", "src/repro/kernels/signature.py:42",
        lambda: KSig.signature(m0, r0), lambda: ref.signature_ref(m0, r0),
        None, nbytes=T8 * G8 + 4 * G8 + 4 * T8, nops=2 * T8 * G8,
        shape=f"T={T8} E={G8} (movielens mode 0, one lane)",
        plain_iters=3))
    td_masks = [m[:td_rows] for m in ml_masks]
    kernels.append(entry(
        "tricluster_density", "tricluster_density.cu",
        "src/repro/kernels/tricluster_density.py:62",
        lambda: KTD.tricluster_density(ml_tens, *td_masks),
        lambda: ref.tricluster_density_ref(ml_tens, *td_masks), None,
        nbytes=G8 * M8 * B8 + td_rows * (G8 + M8 + B8) + 4 * td_rows,
        nops=2 * td_rows * G8 * M8 * B8,
        shape=f"T={td_rows} G={G8} M={M8} B={B8}"
        + (" (cut from 356877: one call took over 30 s)" if cut else ""),
        plain_iters=1, ops_per_s=INT8_TENSOR_OPS_PER_S, iters=5, warm=1))
    for k in kernels[-2:]:
        log(f"{label} {k['name']}: kernel {k['ms']:.5f} ms "
            f"({k['ms_source']}; {k['call_ms']:.5f} ms per call by "
            f"events), plain "
            f"{k['plain_ms']:.5f} ms, no library call, bound "
            f"{k['bound_ms']:.5f} ms ({k['bound_by']}) at {k['shape']}")
    td = kernels[-1]
    td["tops"] = 2 * td_rows * G8 * M8 * B8 / (td["ms"] * 1e-3) / 1e12
    td_plan = KTD.plan(td_rows, G8, M8, B8)
    td["ptxas"] = ptxas_usage(report["tricluster_density"]["log"])
    # what the loaded kernel reports of itself (the C entry's constants
    # and cudaFuncGetAttributes), for the variant this shape launched
    td_cfg = KTD.kernel_config(
        aligned=M8 % 16 == 0 and td_masks[1].data_ptr() % 16 == 0)
    td["smem_bytes_per_block"] = td_cfg["smem_bytes"]
    td["registers"] = td_cfg["registers"]
    log(f"{label} tricluster_density: {td['tops']:.1f} TOP/s of "
        f"{INT8_TENSOR_OPS_PER_S / 1e12:.0f} (int8 tensor cores); "
        f"{td_plan.blocks} blocks of {KTD.TILE_T} x {KTD.TILE_N}, "
        f"{td_plan.chunks} K chunks of {KTD.K_CHUNK} bytes, "
        f"{td['smem_bytes_per_block']} bytes of shared memory a block, "
        f"{td['registers']} registers and {td_cfg['local_bytes']} local "
        f"bytes a thread (CUDA runtime); "
        f"ptxas {td['ptxas'] or '(built earlier: no report)'}")
    # Yardstick, product only, not the same function: cuBLAS's int8 product
    # C = Y I'^T over T-chunks of Y, C written, no X.Z epilogue.  The port
    # never calls it; library_ms stays null (no single call computes the
    # kernel's function).
    try:
        ik_t = ml_tens.permute(0, 2, 1).reshape(G8 * B8, M8).to(
            torch.int8).t()                     # (M, G*B), column-major
        y8 = td_masks[1].view(torch.uint8).view(torch.int8)
        rows8 = 8192

        def int_mm_product():
            for lo in range(0, td_rows, rows8):
                torch._int_mm(y8[lo:lo + rows8], ik_t)
        td["int_mm_product_ms"] = measure(int_mm_product, 2, 1)["ms"]
        log(f"{label} torch._int_mm, product only, not the same function "
            f"(C = Y I'^T written in {rows8}-row chunks, no epilogue): "
            f"{td['int_mm_product_ms']:.5f} ms")
        del ik_t, y8
    except Exception as e:            # a yardstick: log it, go on
        td["int_mm_product_ms"] = None
        log(f"{label} torch._int_mm product: not measured ({e})")
    del ml_masks, td_masks, ml_tens, m0
    torch.cuda.empty_cache()

    # -- phase 9: LM serving ---------------------------------------------------
    # 9a: both serving kernels against their plain versions, at every shape
    # of the JAX package's kernel tests (tests/test_kernels.py) and at the
    # slice's.  fp32: rtol = atol = 2e-5, the JAX tests'.  bf16: one bf16 ulp
    # of each output (rtol 2**-7 >= ulp(|want|) / |want|) plus atol 1e-5 for
    # the order of the fp32 sums near zero; both sides compute in fp32 and
    # round once, so they differ by at most that rounding.  The JAX tests'
    # bf16 2e-2 is as large as a typical decode output (~0.03 at kv_len
    # 2049) and would pass a kernel that drops a 64-key tile.
    def close(got, want, dtype):
        rtol, atol = (2e-5, 2e-5) if dtype == fp32 else (2 ** -7, 1e-5)
        return (got.dtype == want.dtype and got.shape == want.shape
                and bool(torch.isfinite(got).all())
                and torch.allclose(got.float(), want.float(), rtol=rtol,
                                   atol=atol)), \
            float((got.float() - want.float()).abs().max())

    def randn(g, shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    g9 = torch.Generator(device=dev).manual_seed(9)
    dec_errs, norm_errs = {}, {}
    # the key span of one split at the serving shape (B 4 x Hkv 8, kv_len
    # 2049: 4 tiles, 256 keys, on a 132-SM card)
    plan9 = KD.split_plan(2049, None, 4 * 8, KD.sm_count(dev))
    span9 = plan9[1] * KD.KEY_TILE
    log(f"phase 9a decode_attention split plan at the serving shape: "
        f"(first tile, tiles per split, splits) = {plan9} on "
        f"{KD.sm_count(dev)} SMs")
    dec_cases = [((2, 4, 2, 512, 64), 512, None, "contiguous"),
                 ((1, 8, 8, 1024, 64), 700, None, "contiguous"),
                 ((2, 4, 1, 512, 128), 512, 128, "contiguous"),
                 ((1, 2, 2, 300, 32), 300, None, "contiguous"),
                 ((4, 24, 8, 4096, 64), 2049, None, "ring view"),
                 ((4, 24, 8, 4096, 64), 4096, None, "ring view"),
                 # split boundaries: the last split one key long, or one
                 # tile one key short; a window that starts mid-tile
                 ((4, 24, 8, 4096, 64), 8 * span9 - 1, None, "ring view"),
                 ((4, 24, 8, 4096, 64), 4 * span9 + 1, None, "ring view"),
                 ((4, 24, 8, 4096, 64), 4 * span9 - 1, None, "ring view"),
                 ((4, 24, 8, 4096, 64), 3 * span9 + 1, 700, "ring view"),
                 # B x Hkv = 264 fills two blocks per SM: one split
                 ((33, 16, 8, 512, 64), 500, None, "ring view"),
                 # D 80, split, window
                 ((2, 32, 8, 2048, 80), 2000, 1500, "ring view")]
    for (b_, hq_, hkv_, s_, d_), kv_len, window, layout in dec_cases:
        for dtype in (fp32, bf16):
            q9 = randn(g9, (b_, hq_, d_), dtype)
            if layout == "ring view":    # (B, S, Hkv, D), as the cache is
                k9, v9 = (randn(g9, (b_, s_, hkv_, d_), dtype)
                          .permute(0, 2, 1, 3) for _ in range(2))
            else:
                k9, v9 = (randn(g9, (b_, hkv_, s_, d_), dtype)
                          for _ in range(2))
            got = KD.decode_attention(q9, k9, v9, kv_len=kv_len,
                                      window=window)
            want = ref.decode_attention_ref(q9, k9, v9, kv_len=kv_len,
                                            window=window)
            torch.cuda.synchronize()
            ok, e = close(got, want, dtype)
            label = (f"decode_attention B {b_} Hq {hq_} Hkv {hkv_} S {s_} "
                     f"D {d_} kv_len {kv_len} window {window} {layout} "
                     f"{str(dtype)[6:]}")
            check(ok, f"phase 9a {label}: max |err| {e}")
            dec_errs[label] = e
            # the log-sum-exp beside O (what ranks holding blocks of a
            # sharded ring combine with): the same O, and the lse within
            # 2e-5 of the plain version's (both from fp32 scores)
            o_l, lse = KD.decode_attention(q9, k9, v9, kv_len=kv_len,
                                           window=window, return_lse=True)
            w_lse = ref.decode_attention_ref(q9, k9, v9, kv_len=kv_len,
                                             window=window,
                                             return_lse=True)[1]
            e_l = float((lse - w_lse).abs().max())
            check(torch.equal(o_l, got) and lse.dtype == fp32
                  and torch.allclose(lse, w_lse, rtol=2e-5, atol=2e-5),
                  f"phase 9a {label} lse: max |err| {e_l}, O equal "
                  f"{torch.equal(o_l, got)}")
            log(f"phase 9a {label}: max |err| {e:.3e}; lse {e_l:.3e}")
    # a block of a sharded ring with no filled slot: o = 0, lse = -inf,
    # no launch, as the plain version gives
    for dtype in (fp32, bf16):
        q9 = randn(g9, (4, 24, 64), dtype)
        k9 = randn(g9, (4, 2048, 8, 64), dtype).permute(0, 2, 1, 3)
        before = KD.decode_attention.launches
        o0, l0 = KD.decode_attention(q9, k9, k9, kv_len=0, return_lse=True)
        w0, wl0 = ref.decode_attention_ref(q9, k9, k9, kv_len=0,
                                           return_lse=True)
        check(KD.decode_attention.launches == before and torch.equal(o0, w0)
              and torch.equal(l0, wl0) and bool(torch.isneginf(l0).all()),
              f"phase 9a decode_attention kv_len 0 {dtype}")
    log("phase 9a decode_attention kv_len 0 (an empty block of a sharded "
        "ring), fp32 and bf16: o = 0, lse = -inf, no launch, equal to the "
        "plain version")
    for shape, dtype in [(s, t) for s in ((4, 64), (2, 3, 128), (256, 512),
                                          (5, 96)) for t in (fp32, bf16)] + [
            ((4 * 2046, 1536), bf16), ((4, 1536), bf16)]:
        x9 = randn(g9, shape, dtype)
        w9 = torch.randn(shape[-1:], generator=g9, device=dev) + 1.0
        ok, e = close(KN.rmsnorm(x9.reshape(-1, shape[-1]), w9, 1e-5)
                      .reshape(shape), ref.rmsnorm_ref(x9, w9, 1e-5), dtype)
        label = f"rmsnorm {shape} {str(dtype)[6:]}"
        check(ok, f"phase 9a {label}: max |err| {e}")
        norm_errs[label] = e
        log(f"phase 9a {label}: max |err| {e:.3e}")
    del q9, k9, v9, x9, got, want

    # timed at the serving run's shapes: a decode step's attention at
    # pos = 2048 over the bf16 ring view, and a prefill RMSNorm (fp32 weight)
    b_, hq_, hkv_, d_, sc_, kvl = 4, 24, 8, 64, 4096, 2049
    q9 = randn(g9, (b_, hq_, d_), bf16)
    q4 = q9[:, :, None]
    # six distinct rings, 201 MB (their kv_len slices 101 MB, twice the
    # 50 MB L2): a call on the next ring finds none of its keys in L2, as a
    # serving step finds each layer's cache after 31 other layers' caches
    # and the weights.  ms / library_ms reuse ring 0 (warm); cold_ms /
    # library_cold_ms turn through the six.
    rings = [tuple(randn(g9, (b_, sc_, hkv_, d_), bf16).permute(0, 2, 1, 3)
                   for _ in range(2)) for _ in range(6)]
    k9, v9 = rings[0]

    def dec_kernel(k_, v_):
        return KD.decode_attention(q9, k_, v_, kv_len=kvl)

    def dec_sdpa(k_, v_):
        return F.scaled_dot_product_attention(
            q4, k_[:, :, :kvl], v_[:, :, :kvl], enable_gqa=True)

    def rotating(fn):
        turn = [0]

        def call():
            turn[0] = (turn[0] + 1) % len(rings)
            return fn(*rings[turn[0]])
        return call

    kernels.append(entry(
        "decode_attention", "decode_attention.cu",
        "src/repro/kernels/decode_attention.py:81",
        lambda: dec_kernel(k9, v9),
        lambda: ref.decode_attention_ref(q9, k9, v9, kv_len=kvl),
        lambda: dec_sdpa(k9, v9),
        nbytes=2 * 2 * b_ * hkv_ * kvl * d_ + 2 * 2 * b_ * hq_ * d_,
        nops=4 * b_ * hq_ * kvl * d_, ops_per_s=BF16_TENSOR_OPS_PER_S,
        shape=f"B={b_} Hq={hq_} Hkv={hkv_} D={d_} kv_len={kvl} over a "
        f"(B, Sc={sc_}, Hkv, D) bf16 ring view"))
    cold, lib_cold = measure(rotating(dec_kernel)), measure(
        rotating(dec_sdpa))
    kernels[-1].update(cold_ms=cold["ms"], cold_ms_source=cold["source"],
                       library_cold_ms=lib_cold["ms"],
                       split_plan=list(plan9))
    log(f"phase 9a decode_attention L2-cold (6 rings in turn): kernel "
        f"{cold['ms']:.5f} ms ({cold['source']}), SDPA {lib_cold['ms']:.5f}"
        f" ms; bound {kernels[-1]['bound_ms']:.5f} ms = "
        f"{kernels[-1]['bound_ms'] / cold['ms']:.3f} of the cold kernel "
        f"time")
    check(torch.allclose(F.scaled_dot_product_attention(
        q4, k9[:, :, :kvl], v9[:, :, :kvl], enable_gqa=True)[:, :, 0].float(),
        KD.decode_attention(q9, k9, v9, kv_len=kvl).float(), rtol=2e-2,
        atol=2e-2), "decode_attention: SDPA computes another function")
    kernels[-1]["max_abs_err_by_case"] = dec_errs
    errs["decode_attention"] = dec_errs[
        "decode_attention B 4 Hq 24 Hkv 8 S 4096 D 64 kv_len 2049 window "
        "None ring view bfloat16"]
    rows_, dn_ = 4 * 2046, 1536
    x9 = randn(g9, (rows_, dn_), bf16)
    w9 = torch.randn((dn_,), generator=g9, device=dev) + 1.0
    xd = randn(g9, (4, dn_), bf16)          # a decode step's norm
    for xx in (x9, xd, x9.float(), xd.float()):
        p9 = KN.plan_for(xx, w9)
        check(p9.path == "vector", f"rmsnorm {tuple(xx.shape)} {xx.dtype}: "
              f"plan {p9}, not the vector path")
    log(f"phase 9a rmsnorm plans at D {dn_}: bf16 "
        f"{KN.plan_for(x9, w9)}, fp32 {KN.plan_for(x9.float(), w9)}")
    kernels.append(entry(
        "rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:24",
        lambda: KN.rmsnorm(x9, w9, 1e-5),
        lambda: ref.rmsnorm_ref(x9, w9, 1e-5),
        lambda: F.rms_norm(x9, (dn_,), w9, 1e-5),
        nbytes=2 * 2 * rows_ * dn_ + 4 * dn_, nops=4 * rows_ * dn_,
        shape=f"R={rows_} D={dn_} bf16, fp32 weight (a prefill norm)"))
    dec9 = entry(
        "rmsnorm", "rmsnorm.cu", "",
        lambda: KN.rmsnorm(xd, w9, 1e-5),
        lambda: ref.rmsnorm_ref(xd, w9, 1e-5),
        lambda: F.rms_norm(xd, (dn_,), w9, 1e-5),
        nbytes=2 * 2 * 4 * dn_ + 4 * dn_, nops=4 * 4 * dn_,
        shape=f"R=4 D={dn_} bf16, fp32 weight (a decode step's norm)")
    kernels[-1].update(
        decode_ms=dec9["ms"], decode_call_ms=dec9["call_ms"],
        decode_plain_ms=dec9["plain_ms"],
        decode_library_ms=dec9["library_ms"],
        decode_bound_ms=dec9["bound_ms"], decode_shape=dec9["shape"],
        max_abs_err_by_case=norm_errs)
    log(f"phase 9a rmsnorm at {dec9['shape']}: kernel {dec9['ms']:.5f} ms "
        f"({dec9['ms_source']}; {dec9['call_ms']:.5f} ms per call), plain "
        f"{dec9['plain_ms']:.5f} ms, library {dec9['library_ms']:.5f} ms, "
        f"bound {dec9['bound_ms'] * 1e3:.3f} us")
    errs["rmsnorm"] = norm_errs[f"rmsnorm {(rows_, dn_)} bfloat16"]
    for k in kernels[-2:]:
        log(f"phase 9a {k['name']}: kernel {k['ms']:.5f} ms "
            f"({k['ms_source']}; {k['call_ms']:.5f} ms per call), plain "
            f"{k['plain_ms']:.5f} ms, library {k['library_ms']:.5f} ms, "
            f"bound {k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}) at "
            f"{k['shape']}")
    del q9, q4, k9, v9, x9, xd, rings

    # 9b: full-width granite-moe-3b-a800m serving through both kernels
    cfg9 = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                               attn_impl="pallas", use_pallas=True)
    check(cfg9.dtype == "bfloat16", f"granite-moe dtype {cfg9.dtype}")
    model9 = get_model(cfg9)
    params = model9.init(cfg9, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = TokenPipeline(cfg9, 4, 2048, seed=0).prompts(4, 2048)
    lens9 = [len(p) for p in prompts]
    check(lens9 == [2048, 2047, 2046, 2048], f"prompt lengths {lens9}")
    n_new, max_len9 = 32, 4096
    engine = ServeEngine(cfg9, params, max_len=max_len9)
    engine.generate(prompts, n_new)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    paths_before = dict(KN.rmsnorm.path_launches)
    run_a = engine.generate(prompts, n_new)
    serving_counts = ops.launch_counts()
    norm_paths = {k: v - paths_before[k]
                  for k, v in KN.rmsnorm.path_launches.items()}
    peak9 = torch.cuda.max_memory_allocated() / 1e9
    run_b = engine.generate(prompts, n_new)
    steps = run_a.steps
    n_norm = 2 * cfg9.n_layers + 1
    expect9 = {"decode_attention": cfg9.n_layers * steps,
               "rmsnorm": n_norm * (1 + steps)}
    log(f"phase 9b serving run: launches {serving_counts} (expected "
        f"{expect9}, nothing else)")
    check(all(serving_counts[k] > 0 for k in ops.PATH_KERNELS["serving"]),
          f"phase 9b: a kernel of the path was not launched: "
          f"{serving_counts}")
    check({k: serving_counts[k] for k in expect9} == expect9
          and all(n == 0 for k, n in serving_counts.items()
                  if k not in expect9),
          f"phase 9b launches {serving_counts} != {expect9}")
    log(f"phase 9b rmsnorm launches by path: {norm_paths}")
    check(norm_paths["vector"] == serving_counts["rmsnorm"],
          f"phase 9b: rmsnorm left the 16-byte vector path: {norm_paths}")
    check(steps == run_b.steps == max(lens9) - min(lens9) + n_new,
          f"phase 9b steps {steps} / {run_b.steps}")
    for res9 in (run_a, run_b):
        check([len(t) for t in res9.tokens] == [n_new] * 4 and all(
            0 <= t < cfg9.vocab_size for ts in res9.tokens for t in ts),
            f"phase 9b generated tokens {[len(t) for t in res9.tokens]}")
    same9 = run_a.tokens == run_b.tokens
    prefill_ms = min(run_a.prefill_s, run_b.prefill_s) * 1e3
    decode_ms = min(run_a.decode_s, run_b.decode_s) * 1e3
    tok_s = 4 * n_new / (decode_ms / 1e3)
    cache_gb = 2 * cfg9.n_layers * 4 * max_len9 * cfg9.n_kv_heads \
        * cfg9.head_dim * 2 / 1e9
    log(f"phase 9b {cfg9.name} serving (bf16, attn_impl pallas, use_pallas; "
        f"4 prompts {lens9}, {n_new} new tokens each, max_len {max_len9}): "
        f"prefill ms {[round(r.prefill_s * 1e3, 3) for r in (run_a, run_b)]}"
        f" (min {prefill_ms:.3f}); decode ms "
        f"{[round(r.decode_s * 1e3, 3) for r in (run_a, run_b)]} (min "
        f"{decode_ms:.3f}) over {steps} steps ({decode_ms / steps:.3f} ms a "
        f"step; {tok_s:.1f} tokens/s); peak device memory {peak9:.3f} GB "
        f"(bf16 cache {cache_gb:.3f} GB); the two runs' tokens identical: "
        f"{same9}; request 0 starts {run_a.tokens[0][:8]}")
    gen_ms = (run_a.prefill_s + run_a.decode_s) * 1e3
    busy9, by_name9, by_op9, complete9 = device_ms(
        lambda: engine.generate(prompts, n_new), iters=2)
    serve_busy = busy9 if complete9 else None
    if busy9 is not None:
        log("phase 9b generate: " + (
            f"device busy {busy9:.3f} ms of {gen_ms:.3f} ms (idle share "
            f"{1 - busy9 / gen_ms:.3f})" if complete9 else
            "device busy and idle share not measured (profiler trace "
            "incomplete)"))
    # where a decode step's time goes: one step at a time, after a prefill
    pad9 = np.array([p[:min(lens9)] for p in prompts])
    cache9, logits9 = model9.prefill(cfg9, params, {"tokens": pad9},
                                     max_len9)
    check(bool(torch.isfinite(logits9).all())
          and logits9.shape == (4, cfg9.vocab_size),
          f"phase 9b prefill logits {tuple(logits9.shape)}")
    feed9 = torch.argmax(logits9, -1)
    state9 = {"cache": cache9, "feed": feed9}

    def decode_one():
        state9["cache"], lg = model9.decode_step(cfg9, params,
                                                 state9["cache"],
                                                 state9["feed"])
        state9["feed"] = torch.argmax(lg, -1)
        state9["feed"].cpu()

    step_times = []
    for _ in range(8):
        t0 = time.perf_counter()
        decode_one()
        step_times.append((time.perf_counter() - t0) * 1e3)
    step_ms = min(step_times)
    busy, by_name, by_op, complete = device_ms(decode_one, iters=8)
    if busy is not None:
        log(f"phase 9b decode step: warm ms {min(step_times):.3f} (min of "
            f"8); " + (f"device busy {busy:.3f} ms (idle share "
                       f"{1 - busy / step_ms:.3f})" if complete else
                       "device busy and idle share not measured (profiler "
                       "trace incomplete)")
            + "; the largest device activities traced:")
        for kname, kms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            log(f"    {kms:.4f} ms  {kname[:90]}")
        log(f"phase 9b decode step: device ms by the PyTorch op that "
            f"launched it, the largest (ops {sum(by_op.values()):.3f} ms of "
            f"the {busy:.3f} traced ms; the rest launched outside any op):")
        for oname, oms in sorted(by_op.items(), key=lambda kv: -kv[1])[:12]:
            log(f"    {oms:.4f} ms  {oname[:90]}")
    del cache9, state9

    def forced(cfg_, params_, prompts_, gen_, max_len_):
        """Every step's logits of ``prompts_`` decoded as the engine does,
        feeding the prompt and then the tokens ``gen_`` (teacher forcing):
        [prefill logits, step 1, ...]."""
        m_ = get_model(cfg_)
        lens_ = np.array([len(p) for p in prompts_])
        s0, s1 = int(lens_.min()), int(lens_.max())
        pad_ = np.zeros((len(prompts_), s1), np.int64)
        for i, p in enumerate(prompts_):
            pad_[i, :len(p)] = p
        cache_, lg = m_.prefill(cfg_, params_, {"tokens": pad_[:, :s0]},
                                max_len_)
        out_ = [lg]
        n_steps = s1 - s0 + max(len(t) for t in gen_)
        for t in range(n_steps):
            cur = s0 + t
            feed_ = [int(pad_[i, cur]) if cur < lens_[i] else
                     (gen_[i][cur - lens_[i]]
                      if cur - lens_[i] < len(gen_[i]) else 0)
                     for i in range(len(prompts_))]
            cache_, lg = m_.decode_step(cfg_, params_, cache_, feed_)
            out_.append(lg)
        return out_

    # bf16: kernels against the plain path, reported (routes in bf16 do not
    # reproduce across attention implementations; ROADMAP queue C)
    plain9 = dataclasses.replace(cfg9, attn_impl="blocked", use_pallas=False)
    plain_tokens = ServeEngine(plain9, params, max_len=max_len9).generate(
        prompts, n_new).tokens
    agree = np.mean([a == b for ta, tb in zip(run_a.tokens, plain_tokens)
                     for a, b in zip(ta, tb)])
    log(f"phase 9b bf16 greedy tokens agreeing with the plain path "
        f"(attn_impl blocked, use_pallas False): {agree:.4f} of "
        f"{4 * n_new} (reported, not gated)")

    # fp32 gate.  At full depth the kernels' rounding (an ulp) flips top-k
    # routes and the flips cascade (ROADMAP queue C), so: (1) at full depth,
    # teacher-forced on the plain path's greedy tokens, every launch of both
    # kernels is held, on its own inputs, against a float64 evaluation of
    # the same function, within 1e-4 of the output's max |exact| (the real
    # activations' scores reach the hundreds, and an fp32 score of that
    # size carries an absolute error ~1e-4 in any order of its sums, which
    # the softmax passes on: the fp32 plain version errs by a few 1e-5 of
    # max |exact|, printed beside), and the end-to-end difference and the
    # per-layer route divergence are reported; (2) at a depth of
    # GATE_LAYERS, where a flip reaches the logits only through a near-tied
    # route at a position they read (none at this seed), every step's logits,
    # kernels on against off, within 1e-3 of the step's max |logit|
    on32 = dataclasses.replace(cfg9, dtype="float32")
    off32 = dataclasses.replace(plain9, dtype="float32")
    t0 = time.perf_counter()
    gen32 = ServeEngine(off32, params, max_len=max_len9).generate(
        prompts, n_new).tokens
    def decode_f64(q, k, v, *, window=None, kv_len=None, scale=None):
        b, hq, d = q.shape
        hi = k.shape[2] if kv_len is None else kv_len
        lo = 0 if window is None else max(0, hi - window)
        qd = q.double().reshape(b, k.shape[1], -1, d) * (
            d ** -0.5 if scale is None else scale)
        sc = torch.einsum("bhgd,bhkd->bhgk", qd, k[:, :, lo:hi].double())
        return torch.einsum("bhgk,bhkd->bhgd", torch.softmax(sc, -1),
                            v[:, :, lo:hi].double()).reshape(b, hq, d)

    def rmsnorm_f64(x, w, eps=1e-6):
        xd = x.double()
        return xd * torch.rsqrt((xd * xd).mean(-1, keepdim=True) + eps) \
            * w.double()

    def forced_checked(label, *args):
        """``forced(*args)`` with every launch of both serving kernels held
        against a float64 evaluation on its own inputs, within 1e-4 of
        its max |exact|; -> (logits, {kernel: [launches, max relative
        error, the plain version's]})."""
        errs_ = {"decode_attention": [0, 0.0, 0.0], "rmsnorm": [0, 0.0, 0.0]}
        real_ops = (ops.decode_attention, ops.rmsnorm)

        def checked(name, real, plain, exact):
            def run(*a, **kw):
                out = real(*a, **kw)
                want = exact(*a, **kw)
                scale_ = float(want.abs().max())
                e_k = float((out.double() - want).abs().max()) / scale_
                e_p = float((plain(*a, **kw).double() - want).abs().max()) \
                    / scale_
                n = errs_[name][0]
                check(e_k <= 1e-4,
                      f"{label} {name} launch {n}: max |err| {e_k:.3e} of "
                      f"max |exact| against float64 (limit 1e-4; the plain "
                      f"version's {e_p:.3e})")
                errs_[name] = [n + 1, max(errs_[name][1], e_k),
                               max(errs_[name][2], e_p)]
                return out
            return run

        ops.decode_attention = checked("decode_attention", real_ops[0],
                                       ref.decode_attention_ref, decode_f64)
        ops.rmsnorm = checked("rmsnorm", real_ops[1], ref.rmsnorm_ref,
                              rmsnorm_f64)
        try:
            return forced(*args), errs_
        finally:
            ops.decode_attention, ops.rmsnorm = real_ops

    ops.reset_launch_counts()
    lg_on, launch_errs = forced_checked("phase 9b fp32", on32, params,
                                        prompts, gen32, max_len9)
    gate_counts = ops.launch_counts()
    lg_off = forced(off32, params, prompts, gen32, max_len9)
    check(gate_counts["decode_attention"] == cfg9.n_layers * (len(lg_on) - 1)
          == launch_errs["decode_attention"][0]
          and gate_counts["rmsnorm"] == n_norm * len(lg_on)
          == launch_errs["rmsnorm"][0],
          f"phase 9b fp32 launches {gate_counts}, checked {launch_errs}")
    full_rel = max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(lg_on, lg_off))
    full_agree = float(torch.stack([(a.argmax(-1) == b.argmax(-1)).float()
                                    .mean() for a, b in zip(lg_on, lg_off)])
                       .mean())
    pad32 = np.array([p[:min(lens9)] for p in prompts])
    r_on, r_off = (collect_moe_routing(dataclasses.replace(
        c, attn_impl="blocked"), params, pad32) for c in (on32, off32))
    flips = [int(x) for x in (r_on != r_off).reshape(cfg9.n_layers, -1)
             .sum(1)]
    log(f"phase 9b fp32, full depth ({cfg9.n_layers} layers), kernels on, "
        f"teacher-forced over {len(lg_on)} steps: all "
        f"{launch_errs['decode_attention'][0]} decode_attention launches "
        f"(max |err| against float64 {launch_errs['decode_attention'][1]:.3e}"
        f" of max |exact|; the plain version's "
        f"{launch_errs['decode_attention'][2]:.3e}) and "
        f"{launch_errs['rmsnorm'][0]} rmsnorm launches ("
        f"{launch_errs['rmsnorm'][1]:.3e}; plain "
        f"{launch_errs['rmsnorm'][2]:.3e}) within 1e-4; end to end against the "
        f"plain path (reported): worst max |d logit| / max |logit| "
        f"{full_rel:.3e}, greedy agreement {full_agree:.4f}; prefill routes "
        f"differing per layer (of {r_on[0].size}), use_pallas on vs off: "
        f"{flips}")
    del lg_on, lg_off, r_on, r_off
    g_on = dataclasses.replace(on32, n_layers=GATE_LAYERS)
    g_off = dataclasses.replace(off32, n_layers=GATE_LAYERS)
    gen_g = ServeEngine(g_off, params, max_len=max_len9).generate(
        prompts, n_new).tokens
    ops.reset_launch_counts()
    lg_on = forced(g_on, params, prompts, gen_g, max_len9)
    gate_counts = ops.launch_counts()
    lg_off = forced(g_off, params, prompts, gen_g, max_len9)
    check(gate_counts["decode_attention"] == GATE_LAYERS * (len(lg_on) - 1)
          and gate_counts["rmsnorm"] == (2 * GATE_LAYERS + 1) * len(lg_on),
          f"phase 9b fp32 gate launches {gate_counts}")
    worst_rel, argmax_eq = 0.0, []
    for i, (a, b) in enumerate(zip(lg_on, lg_off)):
        rel = float((a - b).abs().max()) / float(b.abs().max())
        worst_rel = max(worst_rel, rel)
        argmax_eq.append((a.argmax(-1) == b.argmax(-1)).float().mean())
        check(bool(torch.isfinite(a).all()) and rel <= 1e-3,
              f"phase 9b fp32 gate step {i}: max |d logit| {rel:.3e} of "
              f"max |logit| (limit 1e-3)")
    share32 = float(torch.stack(argmax_eq).mean())
    log(f"phase 9b fp32 gate ({GATE_LAYERS} of {cfg9.n_layers} layers, full "
        f"width): {len(lg_on)} steps (prefill + {len(lg_on) - 1} decode), "
        f"kernels on vs off: worst max |d logit| / max |logit| "
        f"{worst_rel:.3e} (limit 1e-3); greedy-token agreement "
        f"{share32:.4f}; phase 9b fp32 checks {time.perf_counter() - t0:.1f} "
        "s")
    del params, lg_on, lg_off, engine
    torch.cuda.empty_cache()

    # 9c: ring wrap on the card, windowed smoke configs in fp32: every
    # kernel launch against float64 (as above), and every step's logits,
    # kernels on against off, within 2e-5 of the step's max |logit| (an
    # fp32 tolerance on the logits' scale: the smoke weights' scores reach
    # ~50, so elementwise 2e-5 does not bound fp32 sums in another order)
    for arch in ("h2o-danube-1.8b", "mixtral-8x7b"):
        base = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        on = dataclasses.replace(base, attn_impl="pallas", use_pallas=True)
        off = dataclasses.replace(base, attn_impl="blocked",
                                  use_pallas=False)
        sp = get_model(base).init(
            base, torch.Generator(device=dev).manual_seed(0), device=dev)
        sprompts = TokenPipeline(base, 4, 40, seed=0).batch_at(0)[
            "tokens"].tolist()
        sgen = ServeEngine(off, sp, max_len=64).generate(sprompts, 48).tokens
        ops.reset_launch_counts()
        a_, errs_c = forced_checked(f"phase 9c {base.name}", on, sp,
                                    sprompts, sgen, 64)
        counts = ops.launch_counts()
        b_ = forced(off, sp, sprompts, sgen, 64)
        check(counts["decode_attention"] == 48 * base.n_layers
              and counts["rmsnorm"] == 49 * (2 * base.n_layers + 1),
              f"phase 9c {base.name} launches {counts}")
        worst = 0.0
        for i, (x_, y_) in enumerate(zip(a_, b_)):
            rel = float((x_ - y_).abs().max()) / float(y_.abs().max())
            worst = max(worst, rel)
            check(rel <= 2e-5, f"phase 9c {base.name} step {i}: max |d "
                  f"logit| {rel:.3e} of max |logit| (limit 2e-5)")
        log(f"phase 9c {base.name} fp32, window {base.window}: 40-token "
            f"prompts, 48 decode steps (the ring wraps past position "
            f"{base.window}): every launch within 1e-4 of float64 "
            f"(decode_attention {errs_c['decode_attention'][1]:.3e}, plain "
            f"{errs_c['decode_attention'][2]:.3e}; rmsnorm "
            f"{errs_c['rmsnorm'][1]:.3e}); kernels on vs off within 2e-5 of "
            f"max |logit| at every step (worst {worst:.3e})")

    # -- phase 10: out-of-core and streaming mining --------------------------
    runs10 = phase10(bib, ml, prime_ms, noac_ms)

    # -- phase 11: distributed mining ------------------------------------------
    runs10.update(phase11(bib, ml, prime_ms, noac_ms))

    # -- phase 12: the cluster service -----------------------------------------
    runs10.update(phase12(bib))

    # -- phase 13: the multi-process serving plane ------------------------------
    runs10.update(phase13(bib))

    # -- phase 14: training -----------------------------------------------------
    runs10.update(phase14())

    # -- phase 15: the model on a device mesh -----------------------------------
    runs10.update(phase15())

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "repro" or m.startswith("repro."))
    check(not leaked, f"modules of JAX or the JAX package loaded: {leaked}")

    log(f"end to end: bibsonomy prime warm {prime_ms:.3f} ms "
        f"({BIB_T / (prime_ms / 1e3):.0f} tuples/s, {prime_kept} kept); "
        f"movielens noac warm {noac_ms:.3f} ms "
        f"({ml.num_tuples / (noac_ms / 1e3):.0f} tuples/s, {noac_kept} "
        f"kept); granite-moe routing pass warm {route_ms:.3f} ms (device "
        "busy " + ("not measured" if route_busy is None
                   else f"{route_busy:.3f} ms")
        + f"), its context mined in {mine_ms:.3f} ms; movielens-shape "
        f"dense path warm {min(path_times):.3f} ms; granite-moe serving "
        f"prefill {prefill_ms:.3f} ms, decode {decode_ms:.3f} ms over {steps} "
        f"steps ({tok_s:.1f} tokens/s; device busy "
        + ("not measured" if serve_busy is None
           else f"{serve_busy:.3f} ms of a generate") + ")")
    for k in kernels:
        k["launches_by_run"] = {"batch_prime_bibsonomy":
                                prime_counts[k["name"]],
                                "batch_noac_movielens":
                                noac_counts[k["name"]],
                                "moe_routing_granite":
                                routing_counts[k["name"]],
                                "serving_granite": serving_counts[k["name"]]}
        for run, counts in dense_counts.items():
            k["launches_by_run"][run.replace("phase 8 ", "").replace(
                " ", "_")] = counts[k["name"]]
        for run, counts in runs10.items():
            k["launches_by_run"][re.sub(r"[^a-z0-9]+", "_", run.lower())
                                 .strip("_")] = counts[k["name"]]
        k["launches"] = sum(k["launches_by_run"].values())
        k["max_abs_err"] = errs[k["name"]]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"[chip_smoke] FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
