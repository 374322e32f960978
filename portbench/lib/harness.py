"""One run of one cell: set-up, the measured window, the comparison.

Set-up builds (or loads) the kernels' libraries the traffic names, makes
the pool of ``POOL`` contexts from the seed on the host, builds the miner
once, and warms it with ``WARM_REQUESTS`` requests, and on for
``WARM_SECONDS`` (the first seconds of load run slow: allocator growth,
clocks).  Every traffic mix is a closed loop with one client: request
``i`` mines pool context ``i mod POOL`` and ends
when the ``readback`` leaves (and, with ``exact_density``, the dense
path's exact densities) are on the host.  It closes at the end of the
first request to finish after ``seconds``, so rates are whole requests
over the window's whole time.  A reservoir drawn from the seed keeps
``sample`` requests' leaves; once the window has closed, the peak read
and the program freed, each is compared with the plain reference of its
context.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..data import contexts
from ..reference import exact as ref_exact
from ..reference import mining as ref_mining
from . import compare, isolation, stats, trace
from .manifest import Cell, reader


#: Leaves a sampled request reads back only for the comparison.
EXTRA_LEAVES = ("gen_count", "cardinalities")
#: Distinct contexts a run cycles through, so that no result is reused.
POOL = 4
#: Warm requests in set-up, and the seconds of load they last at least.
WARM_REQUESTS = 2
WARM_SECONDS = 3.0


class IsolationError(RuntimeError):
    """JAX or the JAX package was loaded in the benchmark's process."""


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Request:
    """What one request returns to the window: its host leaves and the
    miner's result (still on the device, for a sampled request's extra
    leaves)."""
    leaves: Dict[str, np.ndarray]
    result: object


class Program:
    """The system under test, built once in set-up: the miner of the
    traffic's variant over the configuration's modes, and the dense path
    when the traffic asks for exact densities."""

    def __init__(self, cfg: dict, traffic: dict, device: str):
        import torch
        from repro_torch.core import BatchMiner, NOACMiner
        self.torch = torch
        self.device = torch.device(device)
        self.sizes = tuple(int(s) for s in cfg["sizes"])
        self.readback = list(traffic["readback"])
        self.exact = bool(traffic.get("exact_density"))
        seed = int(cfg["hash_seed"])
        if traffic["variant"] == "prime":
            self.miner = BatchMiner(self.sizes, theta=traffic["theta"],
                                    seed=seed, device=device)
        elif traffic["variant"] == "noac":
            self.miner = NOACMiner(self.sizes, delta=traffic["delta"],
                                   rho_min=traffic["rho_min"],
                                   minsup=traffic["minsup"], seed=seed,
                                   device=device)
        else:
            raise ValueError(f"unknown variant {traffic['variant']!r}")
        self.noac = traffic["variant"] == "noac"

    def request(self, table: np.ndarray, values: Optional[np.ndarray],
                span: Callable, events: Optional[Dict[str, float]]
                ) -> Request:
        """One request; ``events`` (traced runs) gathers device ms between
        CUDA events around the dense path."""
        from repro_torch.core import batch
        torch = self.torch
        with span("mine"):
            res = (self.miner(table, values) if self.noac
                   else self.miner(table))
        with span("readback"):
            leaves = {k: getattr(res, k).cpu().numpy()
                      for k in self.readback}
        if self.exact:
            timed = events is not None and self.device.type == "cuda"
            with span("dense"):
                tup = torch.from_numpy(table).to(self.device)
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(3)] if timed else []
                if timed:
                    marks[0].record()
                tens = batch.dense_tensor(tup, self.sizes)
                masks = batch.fibers(tens, tup)
                if timed:
                    marks[1].record()
                dens = batch.exact_density_dense(tens, masks)
                if timed:
                    marks[2].record()
                del masks, tens, tup
            with span("dense_readback"):
                leaves["exact_density"] = dens.cpu().numpy()
            if timed:
                events["dense"] = (events.get("dense", 0.0)
                                   + marks[0].elapsed_time(marks[2]))
                events["exact_density"] = (events.get("exact_density", 0.0)
                                           + marks[1].elapsed_time(marks[2]))
        return Request(leaves, res)

    def keep(self, req: Request, slot: Dict[str, np.ndarray]) -> None:
        """Copy a sampled request's leaves, and those only the comparison
        reads, into ``slot``: buffers made and touched in set-up, so that
        keeping a sample leaves the host's memory as a request found it
        (a kept array would make the next request's leaves fault in
        fresh pages)."""
        for k, v in req.leaves.items():
            np.copyto(slot[k], v)
        for k in EXTRA_LEAVES:
            self.torch.from_numpy(slot[k]).copy_(getattr(req.result, k))

    def slot(self, req: Request) -> Dict[str, np.ndarray]:
        """A sample slot shaped as ``req``'s leaves, its pages touched."""
        slot = {k: np.empty_like(v) for k, v in req.leaves.items()}
        for k in EXTRA_LEAVES:
            v = getattr(req.result, k)
            slot[k] = np.empty(tuple(v.shape), str(v.dtype).split(".")[-1])
        self.keep(req, slot)
        return slot


def reference(cell: Cell, table: np.ndarray, values: Optional[np.ndarray],
              device: str, control: bool = False) -> Dict[str, np.ndarray]:
    """The plain reference's leaves of one context; ``control``: the same
    computed one step below the configuration's precision (one 32-bit
    signature lane, bfloat16 densities)."""
    cfg, traffic = cell.config, cell.traffic
    noac = traffic["variant"] == "noac"
    out = ref_mining.mine(
        table, cfg["sizes"], hash_seed=int(cfg["hash_seed"]),
        values=values if noac else None,
        delta=traffic["delta"] if noac else None,
        theta=traffic["rho_min"] if noac else traffic["theta"],
        minsup=traffic.get("minsup", 0), lanes=1 if control else 2,
        bfloat16=control)
    if traffic.get("exact_density"):
        import torch
        out["exact_density"] = ref_exact.exact_densities(
            torch.from_numpy(table).to(device), cfg["sizes"],
            bfloat16=control).numpy()
    return out


def control_leaves(ctl: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The control's output in the program's place: its leaves as the
    program hands them over (int32 bit patterns of the signatures)."""
    got = dict(ctl)
    got["sig_lo"] = ctl["sig_lo"].view(np.int32)
    got["sig_hi"] = ctl["sig_hi"].view(np.int32)
    return got


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        t_process: float, device: str = "cuda") -> dict:
    """One run of ``cell``; returns the result line's object.  Raises
    ``IsolationError`` when JAX or the JAX package is loaded once the
    window has closed (looked for after the comparison, just before the
    result)."""
    import torch
    from repro_torch.kernels import ops
    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        report = build.build_all(tuple(traffic["libraries"]))
        built = {k: round(v["seconds"], 3) for k, v in report.items()
                 if v["built"]}
        log(f"libraries {list(report)}; built now: {built or 'none'}")
    pool = [contexts.make_context(cfg, seed, i) for i in range(POOL)]
    program = Program(cfg, traffic, device)
    nullspan = lambda name: contextlib.nullcontext()
    # the sample slots take their shapes from the first warm request;
    # the warm requests after them find the host's memory as the window
    # will
    req = program.request(*pool[0], nullspan, None)
    keep_n = int(traffic["sample"])
    slots = [program.slot(req) for _ in range(keep_n)]
    del req
    t_warm, i = time.perf_counter(), 1
    while i < WARM_REQUESTS or time.perf_counter() - t_warm < WARM_SECONDS:
        program.request(*pool[i % len(pool)], nullspan, None)
        i += 1
    _sync(torch, dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x5A3B1E])
    samples: List[tuple] = []
    latencies: List[float] = []
    events: Optional[Dict[str, float]] = {} if traced else None
    span = nullspan
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function
        span = lambda name: record_function(trace.SPAN_PREFIX + name)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    n = 0
    with span("window"):
        while True:
            ctx = n % len(pool)
            t0 = time.perf_counter()
            with span("request"):
                req = program.request(*pool[ctx], span, events)
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            j = n if n < keep_n else int(rng.integers(0, n + 1))
            if j < keep_n:
                with span("sample"):
                    program.keep(req, slots[j])
                entry = (n, ctx, slots[j])
                if j < len(samples):
                    samples[j] = entry
                else:
                    samples.append(entry)
            del req
            n += 1
            if t1 - t_start >= seconds:
                break
    window_s = t1 - t_start
    ordered = sorted(latencies)
    log(f"window: {n} requests in {window_s:.3f} s; latency ms min "
        f"{ordered[0] * 1e3:.3f}, p50 {ordered[n // 2] * 1e3:.3f}, p95 "
        f"{ordered[max(0, -(-95 * n // 100) - 1)] * 1e3:.3f}, max "
        f"{ordered[-1] * 1e3:.3f}; slowest at requests "
        f"{sorted(range(n), key=lambda i: -latencies[i])[:8]}; mean ms by "
        f"quarter of the window "
        f"{[round(q * 1e3, 3) for q in stats.quarter_means(latencies)]}")
    if prof is not None:
        _sync(torch, dev)
        prof.stop()
    peak = (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    view = trace.RunView(
        requests=n, latencies_s=latencies, tuples=n * int(cfg["n_tuples"]),
        window_s=window_s, setup_s=setup_s, peak_bytes=peak,
        launches=launches, sizes=program.sizes,
        n_tuples=int(cfg["n_tuples"]), event_ms=events or {})
    breakdown = None
    if prof is not None:
        view.device, view.spans = trace.read_profile(prof)
        win = [s for s in view.spans if s.name == "window"]
        view.window_ns = (win[0].start, win[0].end) if win else (
            min(r.start for r in view.device), max(r.end for r in view.device))
        del prof
        lost = {k: v for k, v in trace.lost_records(view).items()
                if v[0] != v[1]}
        log(f"trace: {len(view.device)} device records, {len(view.spans)} "
            f"spans; port kernels whose records differ from their "
            f"launches (records, launches): {lost or 'none'}")
        breakdown = trace.breakdown(view)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"])(view)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else dev.type),
                   "count": 1, "memory_peak_bytes": peak}
    if traced:
        lo, hi = view.window_ns
        device_info["busy_s"] = view.busy_ns() / 1e9
        device_info["window_s"] = (hi - lo) / 1e9
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    refs: Dict[int, Dict[str, np.ndarray]] = {}
    t_ref = time.perf_counter()
    per_request = []
    for index, ctx, leaves in sorted(samples, key=lambda s: s[1]):
        if ctx not in refs:
            refs = {ctx: reference(cell, *pool[ctx], device)}
        nums = compare.numbers(leaves, refs[ctx])
        per_request.append(nums)
        log(f"request {index} (context {ctx}): "
            + ", ".join(f"{k} {v!r}" for k, v in nums.items()))
    log(f"reference: {len(per_request)} requests of {n} compared in "
        f"{time.perf_counter() - t_ref:.3f} s")
    nums = compare.combine(per_request)
    failed = sum(not compare.judge(p, cell.limits) for p in per_request)
    correct = bool(per_request) and compare.judge(nums, cell.limits)
    check = {k: {"value": nums.get(k), "limit": lim}
             for k, lim in cell.limits.items()}
    found = isolation.forbidden_modules()
    if found:
        raise IsolationError(f"modules loaded in the benchmark's process: "
                             f"{found}")
    out = {"correct": correct, "attempted": n, "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = check
    for k, c in check.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return out
