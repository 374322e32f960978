"""Where the time of ``tricluster_density``'s tile kernel goes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.probe_tricluster_density

Three readings at the dense path's MovieLens-1M shape (T 356,877, G × M ×
B = 6,040 × 3,952 × 5; random 0/1 operands from ``--seed``: the dense
kernel's time does not depend on the data):

1. ``mma_peak``: the rate of u8 ``mma.sync`` m16n8k32 alone, in the tile
   kernel's warp shape (4 × 8 fragments a warp, 4 warps a block), operands
   in registers, at 1, 2 and 4 blocks an SM: the ceiling of any
   ``mma.sync`` design.
2. ``current``: the kernel as built from ``csrc/tricluster_density.cu``,
   checked bit-equal to the plain version.
3. ``noload`` and ``noload_nobar``: the same source with the K loop's
   ``cp.async`` loads taken out (it multiplies whatever the prologue
   staged), and then also its wait and barrier.  Their results are wrong
   by design; only their times are read.  ``current − noload`` is the
   cost of feeding the ring, ``noload − noload_nobar`` that of the
   loop's barriers.

Each time is the mean of ``--iters`` calls timed by CUDA events, queued
behind a sleep kernel, in the order current, noload, noload_nobar and
then back.  The last line is one JSON object of every reading with the
card's name and power limit.  Needs the card and ``nvcc``; the variants
are built into ``_build/`` beside the port's kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from typing import Dict

from . import build

_SRC = build.CSRC / "tricluster_density.cu"

# The K loop's loads, then its wait and barrier, as they stand in the
# source; the probe stops if they no longer do.
_LOADS = """    if (nk < chunks)
      load_chunk<ALIGNED>(a, smem + (nk % STAGES) * STAGE_BYTES, t0, n0,
                          nk * K_CHUNK);
"""
_WAIT = """    cp_async_wait<STAGES - 2>();   // chunk kc has landed
    __syncthreads();               // ... for every thread; kc-1 is consumed
"""

_PEAK = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void __launch_bounds__(128) mma_peak(int* out, int iters,
                                                 uint32_t seed) {
  uint32_t a[4][4], b[8][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = seed * (4 * i + j + 1) ^ threadIdx.x;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) b[i][j] = seed * (2 * i + j + 17) ^ threadIdx.x;
  int acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(acc[mb][nb][0]), "+r"(acc[mb][nb][1]),
              "+r"(acc[mb][nb][2]), "+r"(acc[mb][nb][3])
            : "r"(a[mb][0]), "r"(a[mb][1]), "r"(a[mb][2]), "r"(a[mb][3]),
              "r"(b[nb][0]), "r"(b[nb][1]));
  }
  int s = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s += acc[i][j][e];
  out[blockIdx.x * 128 + threadIdx.x] = s;
}
extern "C" int mma_peak_launch(void* out, int blocks, int iters,
                               void* stream) {
  mma_peak<<<blocks, 128, 0, (cudaStream_t)stream>>>((int*)out, iters,
                                                     0x9e3779b9u);
  return (int)cudaGetLastError();
}
"""


def _variants() -> Dict[str, str]:
    src = _SRC.read_text()
    for what, text in (("loads", _LOADS), ("wait and barrier", _WAIT)):
        if src.count(text) != 1:
            raise RuntimeError(f"the K loop's {what} are not in {_SRC} as "
                               "the probe expects: update the probe")
    noload = src.replace(_LOADS, "    (void)nk;\n")
    return {"mma_peak": _PEAK, "noload": noload,
            "noload_nobar": noload.replace(_WAIT, "")}


def _build(sources: Dict[str, str]) -> Dict[str, dict]:
    """Compile each source into its own library, all at once."""
    out_dir = build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        digest = hashlib.sha256((text + " ".join(build.NVCC_FLAGS))
                                .encode()).hexdigest()[:12]
        cu = out_dir / f"{name}-{digest}.cu"
        so = out_dir / f"lib{name}-{digest}.so"
        cu.write_text(text)
        cmd = [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(so), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        libs[name] = {"lib": ctypes.CDLL(str(so)),
                      "ptxas": [ln.strip() for ln in log.splitlines()
                                if "registers" in ln]}
    return libs


def _time_ms(fn, iters: int) -> float:
    """Mean ms of one ``fn()`` over ``iters`` calls queued behind a sleep
    kernel, by CUDA events (one warm call first)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=356_877)
    ap.add_argument("--g", type=int, default=6_040)
    ap.add_argument("--m", type=int, default=3_952)
    ap.add_argument("--b", type=int, default=5)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from . import ref
    from . import tricluster_density as KTD
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs the card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs = _build(_variants())
    rec = {"card": card, "shape": [args.t, args.g, args.m, args.b],
           "ptxas": {k: v["ptxas"] for k, v in libs.items()}}
    for k, v in rec["ptxas"].items():
        print(k, v, flush=True)

    # 1. u8 mma.sync alone
    peak = libs["mma_peak"]["lib"]
    peak.mma_peak_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    rec["mma_peak"] = {}
    mma_iters = 20_000
    for per_sm in (1, 2, 4):
        blocks = sms * per_sm
        sink = torch.empty(blocks * 128, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def run_peak():
            err = peak.mma_peak_launch(sink.data_ptr(), blocks, mma_iters,
                                       stream)
            if err:
                raise RuntimeError(f"mma_peak failed to launch: {err}")
        ms = _time_ms(run_peak, 3)
        ops = blocks * 4 * mma_iters * 32 * (16 * 8 * 32 * 2)
        rec["mma_peak"][per_sm] = {"ms": ms, "tops": ops / (ms * 1e-3)
                                   / 1e12}
        print(f"mma_peak blocks/SM {per_sm}: {ms:.4f} ms, "
              f"{rec['mma_peak'][per_sm]['tops']:.1f} TOP/s", flush=True)

    # 2, 3. the kernel and its variants at the full shape
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=gen, device=dev,
                             dtype=torch.uint8)
    tensor = bits(args.g, args.m, args.b)
    x, y, z = bits(args.t, args.g), bits(args.t, args.m), bits(args.t, args.b)
    got = KTD.tricluster_density(tensor, x, y, z)
    rec["current_equal"] = bool(torch.equal(
        got, ref.tricluster_density_ref(tensor, x, y, z)))
    print("current bit-equal to the plain version:", rec["current_equal"],
          flush=True)
    lib = KTD._lib()
    words = lib.tricluster_density_scratch_words(args.g, args.m,
                                                 args.b) + 2 * args.t
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    out = torch.empty((args.t,), dtype=torch.float32, device=dev)

    def launcher(vlib):
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        vlib.tricluster_density_launch.argtypes = [vp] * 6 + [i64] * 4 + [vp]
        vlib.tricluster_density_launch.restype = ctypes.c_int

        def run():
            err = vlib.tricluster_density_launch(
                tensor.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), args.t, args.g, args.m,
                args.b, torch.cuda.current_stream().cuda_stream)
            build.check(vlib, "tricluster_density", err)
        return run
    runs = {"current": lambda: KTD.tricluster_density(tensor, x, y, z),
            "noload": launcher(libs["noload"]["lib"]),
            "noload_nobar": launcher(libs["noload_nobar"]["lib"])}
    order = list(runs) + list(reversed(runs))
    times: Dict[str, list] = {k: [] for k in runs}
    for name in order:
        ms = _time_ms(runs[name], args.iters)
        times[name].append(ms)
        print(f"{name}: {ms:.3f} ms", flush=True)
    rec["ms"] = times
    ops = 2 * args.t * args.g * args.m * args.b
    rec["tops"] = {k: ops / (min(v) * 1e-3) / 1e12 for k, v in times.items()}
    print(json.dumps(rec))
    return 0 if rec["current_equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
