"""Where the time of ``segment_reduce``'s one-sweep kernel goes, on the
card.

    PYTHONPATH=src python -m repro_torch.kernels.probe_segment_reduce

Readings at the BibSonomy table's size (T 816,197) on random weights and
flags from ``--seed`` (40% of them set): one call of the (T + 1) entry
(the scratch's memset and the sweep), for

1. ``current``: the kernel as built from ``csrc/segment_reduce.cu``, on
   16-byte loads, and ``current_scalar``, the same library on one load
   an element (the path of inputs off 16 bytes);
2. ``blocked``: a thread holds a run of 16 contiguous elements (four
   16-byte loads of each weight lane at a 64-byte stride across the
   lanes, one of the flags) and scans it serially, in place of a warp's
   lanes holding 4 contiguous elements of each 128-element chunk;
3. ``wide``: a look-back step of 256 words (8 a lane) instead of
   ``LOOKBACK``;
4. ``items8``: 8 elements a thread (2 chunks), tiles of 2,048 (twice as
   many tiles);
5. ``tile8k``: blocks of 512 threads, tiles of 8,192 elements (half as
   many tiles);
6. ``no_lookback``: every tile publishes INCLUSIVE at once and adds no
   predecessor (wrong by design): the look-back's cost is ``current −
   no_lookback``.

Each variant but those wrong by design is checked bit-equal to
``ref.segment_reduce_ref``.  Each time is the mean of ``--iters`` calls
timed by CUDA events, queued behind a sleep kernel, in the order of the
list and then back; the smaller of the two counts.  The last line is one
JSON object of every reading with the card's name and power limit.
Needs the card and ``nvcc``; the variants are built into
``_build/probe`` beside the port's kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Dict, List, Tuple

from . import build
from .probe_tricluster_density import _build, _time_ms

_SRC = build.CSRC / "segment_reduce.cu"
_LOOKBACK = "constexpr int LOOKBACK = 32; "
_TPB = "constexpr int TPB = 256; "
_ITEMS = "constexpr int ITEMS = 16; "
_TILE0 = "  if (tile == 0) {\n    if (lane == 0) store_relaxed(st, INCLUSIVE"

#: Variants whose sums are wrong by design.
WRONG_BY_DESIGN = ("no_lookback",)


def _patched(src: str, edits: List[Tuple[str, str]]) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} is not once in {_SRC} as the probe "
                               "expects: update the probe")
        src = src.replace(old, new)
    return src


def _const(name_value: str, value: int) -> Tuple[str, str]:
    return name_value, f"{name_value.split('=')[0]}= {value}; "


_KERNEL_START = ("// VEC: 16-byte loads (w_lo, w_hi and first on 16-byte "
                 "boundaries).")
_KERNEL_END = "namespace {\n\ntemplate <bool VEC>\nconst void* sweep_kernel()"
_BLOCKED = r"""template <bool VEC>
__global__ void __launch_bounds__(TPB)
sr_onesweep(const uint32_t* __restrict__ w_lo,
            const uint32_t* __restrict__ w_hi,
            const uint8_t* __restrict__ first, uint32_t* __restrict__ ex_lo,
            uint32_t* __restrict__ ex_hi, int32_t* __restrict__ ex_cnt,
            unsigned long long* __restrict__ scratch, int n) {
  __shared__ uint32_t tile_prefix[LANES];
  const int tile = claim_tile(scratch);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i0 = (long long)tile * TILE + (long long)threadIdx.x * ITEMS;
  const bool full = i0 + ITEMS <= n;
  uint32_t lo[ITEMS], hi[ITEMS];
  unsigned mask = 0u;
  if (VEC && full) {
    const uint4 f = __ldg(reinterpret_cast<const uint4*>(first + i0));
    const uint32_t fw[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(w_lo + i0) + q);
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(w_hi + i0) + q);
      lo[4 * q] = a.x; lo[4 * q + 1] = a.y;
      lo[4 * q + 2] = a.z; lo[4 * q + 3] = a.w;
      hi[4 * q] = b.x; hi[4 * q + 1] = b.y;
      hi[4 * q + 2] = b.z; hi[4 * q + 3] = b.w;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if ((fw[k >> 2] >> (8 * (k & 3))) & 0xffu) mask |= 1u << k;
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = i0 + k;
      lo[k] = hi[k] = 0u;
      if (i < n) {
        lo[k] = __ldg(w_lo + i);
        hi[k] = __ldg(w_hi + i);
        if (__ldg(first + i)) mask |= 1u << k;
      }
    }
  }
  Lanes run{0u, 0u, __popc(mask)};
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool on = (mask >> k) & 1u;
    lo[k] = on ? lo[k] : 0u;
    hi[k] = on ? hi[k] : 0u;
    run.lo += lo[k];
    run.hi += hi[k];
  }
  const Lanes inc = warp_inclusive_scan(run);
  Lanes ex = shfl_up(inc, 1);
  if (lane == 0) ex = Lanes{};
  Lanes total;
  const Lanes before =
      block_exclusive_scan_warps<Lanes, TPB>(shfl_idx(inc, 31), &total) + ex;
  if (warp < LANES) {
    const uint32_t agg = warp == 0 ? total.lo
                         : warp == 1 ? total.hi : (uint32_t)total.cnt;
    const uint32_t p = warp_lookback(
        status_words(scratch) + (long long)warp * gridDim.x, tile, agg, lane);
    if (lane == 0) tile_prefix[warp] = p;
  }
  __syncthreads();
  Lanes acc = Lanes{tile_prefix[0], tile_prefix[1], (int32_t)tile_prefix[2]} +
              before;
  if (full) {
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      uint32_t a[4], b[4];
      int32_t c[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 4 * q + r;
        a[r] = acc.lo;
        b[r] = acc.hi;
        c[r] = acc.cnt;
        acc = acc + Lanes{lo[k], hi[k], (int32_t)((mask >> k) & 1u)};
      }
      reinterpret_cast<uint4*>(ex_lo + i0)[q] =
          make_uint4(a[0], a[1], a[2], a[3]);
      reinterpret_cast<uint4*>(ex_hi + i0)[q] =
          make_uint4(b[0], b[1], b[2], b[3]);
      reinterpret_cast<int4*>(ex_cnt + i0)[q] =
          make_int4(c[0], c[1], c[2], c[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = i0 + k;
      if (i < n) {
        ex_lo[i] = acc.lo;
        ex_hi[i] = acc.hi;
        ex_cnt[i] = acc.cnt;
      }
      acc = acc + Lanes{lo[k], hi[k], (int32_t)((mask >> k) & 1u)};
    }
  }
  if (i0 < n && i0 + ITEMS >= n) {
    ex_lo[n] = acc.lo;
    ex_hi[n] = acc.hi;
    ex_cnt[n] = acc.cnt;
  }
}

"""


def variants() -> Dict[str, str]:
    """The patched sources, by variant name."""
    src = _SRC.read_text()
    a, b = src.index(_KERNEL_START), src.index(_KERNEL_END)
    return {
        "blocked": src[:a] + _BLOCKED + src[b:],
        "wide": _patched(src, [_const(_LOOKBACK, 256)]),
        "items8": _patched(src, [_const(_ITEMS, 8)]),
        "tile8k": _patched(src, [_const(_TPB, 512)]),
        "no_lookback": _patched(src, [
            (_TILE0, _TILE0.replace("tile == 0", "true")
             .replace("store_relaxed(st,", "store_relaxed(st + tile,"))]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=816_197)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from . import ref
    from . import segment_reduce as KS
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs the card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = _build(variants())
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t = args.t
    w_lo, w_hi = (torch.randint(-2**31, 2**31 - 1, (t,), generator=gen,
                                device=dev, dtype=torch.int32)
                  for _ in range(2))
    first = torch.rand((t,), generator=gen, device=dev) < 0.4
    want = [torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), x])
            for x in ref.segment_reduce_ref(w_lo, w_hi, first)]
    out = torch.empty((3, t + 1 + (-(t + 1)) % 4), dtype=torch.int32,
                      device=dev)

    def runner(lib, vector):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.segment_reduce_launch.argtypes = [vp] * 7 + [ci, ci, vp]
        lib.segment_reduce_scratch_ints.argtypes = [ci]
        scratch = torch.empty((lib.segment_reduce_scratch_ints(t),),
                              dtype=torch.int32, device=dev)

        def run():
            build.check(lib, "segment_reduce", lib.segment_reduce_launch(
                w_lo.data_ptr(), w_hi.data_ptr(), first.data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                scratch.data_ptr(), t, vector,
                torch.cuda.current_stream().cuda_stream))
        return run

    runs = {"current": runner(KS._lib(), 1),
            "current_scalar": runner(KS._lib(), 0)}
    runs.update({k: runner(v["lib"], 1) for k, v in libs.items()})
    rec = {"card": card, "t": t,
           "ptxas": {k: v["ptxas"] for k, v in libs.items()},
           "bit_equal": {}, "ms": {}}
    for name, run in runs.items():
        run()
        torch.cuda.synchronize()
        rec["bit_equal"][name] = all(
            torch.equal(out[k, :t + 1], want[k]) for k in range(3))
    for name in list(runs) + list(reversed(runs)):
        ms = _time_ms(runs[name], args.iters)
        rec["ms"][name] = min(ms, rec["ms"].get(name, ms))
    for name, ms in rec["ms"].items():
        print(f"{name}: {ms * 1e3:.2f} us; bit-equal "
              f"{rec['bit_equal'][name]}; ptxas "
              f"{rec['ptxas'].get(name, 'as built')}", flush=True)
    print(json.dumps(rec))
    ok = all(v for k, v in rec["bit_equal"].items()
             if k not in WRONG_BY_DESIGN)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
