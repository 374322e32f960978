"""Designs of ``radix_histogram``'s increments, timed on the card.

    PYTHONPATH=src python -m repro_torch.kernels.probe_radix_histogram

Readings at the BibSonomy table's size (T 816,197) on two inputs: the
skewed keys of the main path (mode 0's 2-word, 44-bit packed keys of
``data.synthetic.bibsonomy_like``, in the context's order, 6 passes) and
uniform 64-bit words (random signature pairs from ``--seed``, 8 passes).
The variants are the kernel of ``csrc/radix_sort.cu`` with its increment
(``add_digits``), its shared layout or its grid patched:

1. ``current``: the kernel as built, the one the port launches (one
   plain shared atomic a key);
2. ``runs``: a lane adds each run of equal digits among its 4
   consecutive keys with one atomic;
3. ``lead``: warp-aggregated: a warp whose live lanes all hold the
   lowest live lane's digit adds them with one atomic, else each lane
   adds its own (one shuffle and one ballot a key);
4. ``peers``: the full multi-split: each lane's peers by one ballot per
   digit bit (as ``peers_of``, ``width`` ballots), the lowest peer adds
   their number, one atomic per distinct digit of a warp;
5. ``private``: per-warp sub-histograms (8 copies of each bucket, a warp
   on copy warp % 8; 48 KiB at 6 passes, 64 KiB at 8), one atomic a key;
6. ``copies8``: 8 copies of each bucket, lane l on copy l % 8 (CUB's
   interleaved sub-histograms);
7. ``blocks2x512``: two blocks of 512 threads an SM instead of one of
   1,024 (twice the flush's global atomics);
8. ``no_flush``: the blocks never add their histograms into the output
   (wrong by design): the flush's cost is ``current − no_flush``;
9. ``no_count``: loads and digits but no shared atomic (wrong by
   design): the counting's cost is ``current − no_count``;
10. ``no_memset``: the output is not zeroed (wrong by design): the
    memset's cost is ``current − no_memset``;
11. ``empty``: the kernel returns at once (wrong by design): the memset
    and an empty launch of the same grid;
12. ``coop``: no memset: a cooperative launch whose block 0 zeroes the
    output, and a grid barrier (``this_grid().sync()``) before the
    flush.

It also lists the shared-memory atomic opcodes of the built kernel
(``cuobjdump -sass``): ``ATOMS.POPC.INC`` adds, in one operation, the
number of lanes of a warp that hit one address.

Each time is the mean of ``--iters`` calls (the output's memset and the
launch) timed by CUDA events, queued behind a sleep kernel, in the order
of the list and then back; the smaller of the two counts.  The last line
is one JSON object of every reading with the card's name and power
limit.  Needs the card and ``nvcc``; the variants are built into
``_build/probe`` beside the port's kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import build
from .probe_tricluster_density import _build, _time_ms

_SRC = build.CSRC / "radix_sort.cu"

_COPIES = "constexpr int H_COPIES = 1; "
_THREADS = "constexpr int H_THREADS = 1024; "
_PER_SM = "constexpr int H_BLOCKS_PER_SM = 1; "
_BODY_START = "#pragma unroll\n  for (int k = 0; k < H_KEYS; ++k)\n"
_BODY_END = "    if (k < keys) atomicAdd(&h[slot(p, d[k], lane)], 1);\n"
_ADD = "    add_digits(h, p, d, keys, lane);"
_SLOT = "  return (p * BUCKETS + d) * H_COPIES + lane % H_COPIES;"
_FLUSH = "    if (c != 0) atomicAdd(&out[j], c);"
_MEMSET = """  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)npass * BUCKETS * sizeof(int), s);"""
_KERNEL_START = "  extern __shared__ int h[];\n"
_RUNS = """  int last = d[0], run = keys > 0 ? 1 : 0;
#pragma unroll
  for (int k = 1; k < H_KEYS; ++k) {
    if (k < keys) {
      if (d[k] == last) {
        ++run;
      } else {
        atomicAdd(&h[slot(p, last, lane)], run);
        last = d[k];
        run = 1;
      }
    }
  }
  if (run) atomicAdd(&h[slot(p, last, lane)], run);
"""
_LEAD = """#pragma unroll
  for (int k = 0; k < H_KEYS; ++k) {
    const unsigned left = __ballot_sync(FULL_MASK, k < keys);
    if (left == 0u) break;
    const int src = __ffs(left) - 1;
    const int lead = __shfl_sync(FULL_MASK, d[k], src);
    if ((__ballot_sync(FULL_MASK, d[k] == lead) & left) == left) {
      if (lane == src) atomicAdd(&h[slot(p, lead, lane)], __popc(left));
    } else if (k < keys) {
      atomicAdd(&h[slot(p, d[k], lane)], 1);
    }
  }
"""
_PEERS_FN = """// The full multi-split (probe variant): an atomic a distinct digit.
__device__ __forceinline__ void add_digits_peers(int* h, int p,
                                                 const int (&d)[H_KEYS],
                                                 int keys, int lane,
                                                 int width) {
#pragma unroll
  for (int k = 0; k < H_KEYS; ++k) {
    const bool on = k < keys;
    unsigned peers = __ballot_sync(FULL_MASK, on);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (b >= width) break;
      const bool bit = (d[k] >> b) & 1;
      const unsigned set = __ballot_sync(FULL_MASK, bit);
      peers &= bit ? set : ~set;
    }
    if (on && (peers & ((1u << lane) - 1u)) == 0u)
      atomicAdd(&h[slot(p, d[k], lane)], __popc(peers));
  }
}

"""
_KEY_FN = "// Key vector v (keys 4v .. 4v + 3)"

#: Blocks an SM each variant's grid takes (the plan's own otherwise).
_BLOCKS_PER_SM = {"blocks2x512": 2}
#: Variants whose histograms are wrong by design.
WRONG_BY_DESIGN = ("no_flush", "no_count", "no_memset", "empty")
_ZERO = ("  for (int j = threadIdx.x; j < H_COPIES * cells; j += H_THREADS) "
         "h[j] = 0;\n")
_COOP = [
    ("#include <cstdint>\n",
     "#include <cooperative_groups.h>\n#include <cstdint>\n"),
    (_ZERO, _ZERO + "  if (blockIdx.x == 0)\n"
                    "    for (int j = threadIdx.x; j < cells; j += H_THREADS)"
                    " out[j] = 0;\n"),
    ("  __syncthreads();\n"
     "  for (int j = threadIdx.x; j < cells; j += H_THREADS) {\n",
     "  cooperative_groups::this_grid().sync();\n"
     "  for (int j = threadIdx.x; j < cells; j += H_THREADS) {\n"),
    ("""  radix_hist_kernel<VEC, NW><<<blocks, H_THREADS, smem, s>>>(hi, lo, plan,
                                                            out, n);
  return cudaGetLastError();""",
     """  void* args[] = {(void*)&hi, (void*)&lo, (void*)&plan, (void*)&out,
                  (void*)&n};
  return cudaLaunchCooperativeKernel((const void*)radix_hist_kernel<VEC, NW>,
                                     dim3(blocks), dim3(H_THREADS), args,
                                     smem, s);"""),
]


def _patched(src: str, edits: List[Tuple[str, str]]) -> str:
    for old, new in edits:
        if src.count(old) < 1:
            raise RuntimeError(f"{old!r} is not in {_SRC} as the probe "
                               "expects: update the probe")
        src = src.replace(old, new)
    return src


def _const(name_value: str, value: int) -> Tuple[str, str]:
    name = name_value.split("=")[0]
    return name_value, f"{name}= {value}; "


def _body(src: str, body: str) -> str:
    """``src`` with ``add_digits``'s body replaced by ``body``."""
    a = src.index(_BODY_START)
    b = src.index(_BODY_END) + len(_BODY_END)
    return src[:a] + body + src[b:]


def variants() -> Dict[str, str]:
    """The patched sources, by variant name."""
    src = _SRC.read_text()
    for mark in (_BODY_START, _BODY_END):
        _patched(src, [(mark, mark)])
    return {
        "runs": _body(src, _RUNS),
        "lead": _body(src, _LEAD),
        "peers": _patched(src, [
            (_KEY_FN, _PEERS_FN + _KEY_FN),
            (_ADD, "    add_digits_peers(h, p, d, keys, lane, "
                   "plan.width[p]);")]),
        "private": _patched(src, [
            _const(_COPIES, 8),
            (_SLOT, "  return (p * BUCKETS + d) * H_COPIES + "
                    "(threadIdx.x >> 5) % H_COPIES;")]),
        "copies8": _patched(src, [_const(_COPIES, 8)]),
        "blocks2x512": _patched(src, [_const(_THREADS, 512),
                                      _const(_PER_SM, 2)]),
        "no_flush": _patched(src, [(_FLUSH, "    if (c == -1) out[j] = c;")]),
        "no_count": _body(src, """  if (d[0] + d[1] + d[2] + d[3] == -1 - keys)
    atomicAdd(&h[slot(p, 0, lane)], 1);
"""),
        "no_memset": _patched(src, [(_MEMSET,
                                     "  cudaError_t err = cudaSuccess;")]),
        "empty": _patched(src, [(_KERNEL_START,
                                 "  if (n > 0) return;\n" + _KERNEL_START)]),
        "coop": _patched(src, _COOP + [(_MEMSET,
                                        "  cudaError_t err = cudaSuccess;")]),
    }


def shared_atomic_opcodes() -> Dict[str, int]:
    """{SASS opcode: count} of the shared-memory atomics in the built
    ``radix_sort`` library (``cuobjdump -sass``)."""
    import re
    from pathlib import Path
    tool = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(build.library_path("radix_sort"))],
                          capture_output=True, text=True, check=True).stdout
    found: Dict[str, int] = {}
    for op in re.findall(r"\b(ATOMS\.[A-Z0-9.]+)", sass):
        found[op] = found.get(op, 0) + 1
    return found


def time_designs(inputs: Dict[str, Tuple[Sequence, Sequence[int],
                                         Sequence[int]]],
                 iters: int = 20,
                 names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Build the variants (``names``, default all), check each (but those
    wrong by design) bit-equal to ``ref.radix_histogram_ref`` on every
    input, and time them with the current kernel.  ``inputs``: label ->
    (1-2 aligned CUDA key words, shifts, widths).  Returns {variant:
    {"ptxas": [...], "bit_equal": bool, "ms": {label: ms}}}, ``current``
    first."""
    import torch
    from ..device import sm_count
    from . import radix_sort as KR
    from . import ref
    sources = variants()
    libs = {"current": {"lib": KR._lib(), "ptxas": []}}
    libs.update(_build({k: v for k, v in sources.items()
                        if names is None or k in names}))
    sms = sm_count(torch.device("cuda"))
    runs: Dict[str, Dict[str, Callable[[], None]]] = {}
    outs: Dict[str, Dict[str, "torch.Tensor"]] = {}
    for name, v in libs.items():
        lib = v["lib"]
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.radix_histogram_launch.argtypes = [vp, vp, ip, ip, ci, vp, ci,
                                               ci, ci, vp]
        per_sm = _BLOCKS_PER_SM.get(name, KR.HIST_BLOCKS_PER_SM)
        runs[name], outs[name] = {}, {}
        for label, (words, shifts, widths) in inputs.items():
            n = words[0].shape[0]
            plan = KR.hist_plan(n, True, sms)
            blocks = max(1, min(sms * per_sm, -(-plan.vectors // (
                KR.HIST_THREADS * KR.HIST_BLOCKS_PER_SM // per_sm))))
            out = torch.empty((len(shifts), 256), dtype=torch.int32,
                              device="cuda")
            c_s, c_w = KR._digits(shifts, widths)
            hi = words[0].data_ptr() if len(words) == 2 else None

            def run(lib=lib, hi=hi, lo=words[-1].data_ptr(), c_s=c_s,
                    c_w=c_w, npass=len(shifts), out=out, n=n,
                    blocks=blocks):
                build.check(lib, "radix_sort", lib.radix_histogram_launch(
                    hi, lo, c_s, c_w, npass, out.data_ptr(), n, 1, blocks,
                    torch.cuda.current_stream().cuda_stream))
            runs[name][label], outs[name][label] = run, out
    rec = {}
    for name in libs:
        equal = True
        for label, (words, shifts, widths) in inputs.items():
            runs[name][label]()
            torch.cuda.synchronize()
            equal &= bool(torch.equal(outs[name][label],
                                      ref.radix_histogram_ref(
                                          words, shifts, widths)))
        rec[name] = {"ptxas": libs[name]["ptxas"], "bit_equal": equal,
                     "ms": {}}
    order = list(libs) + list(reversed(libs))
    for name in order:
        for label in inputs:
            ms = _time_ms(runs[name][label], iters)
            old = rec[name]["ms"].get(label)
            rec[name]["ms"][label] = ms if old is None else min(old, ms)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from ..core import keys as K
    from ..core import radix as RX
    from ..data import synthetic as S
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs the card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    bib = S.bibsonomy_like()
    plan0 = K.plan_context_keys(bib.sizes, with_values=False)[0]
    skewed = plan0.pack_device(torch.from_numpy(bib.tuples).to(dev))
    rp = RX.plan_radix(plan0.total_bits, bib.num_tuples, RX.HIST_DIGIT_BITS)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    uniform = [torch.randint(-2**31, 2**31 - 1, (bib.num_tuples,),
                             generator=gen, device=dev, dtype=torch.int32)
               for _ in range(2)]
    ru = RX.plan_radix(64, bib.num_tuples, RX.HIST_DIGIT_BITS)
    rec = time_designs({"skewed": (skewed, rp.shifts, rp.widths),
                        "uniform": (uniform, ru.shifts, ru.widths)},
                       args.iters)
    for name, r in rec.items():
        print(f"{name}: bit-equal {r['bit_equal']}; " + ", ".join(
            f"{k} {ms * 1e3:.2f} us" for k, ms in r["ms"].items())
            + f"; ptxas {r['ptxas'] or 'as built'}", flush=True)
    ops = shared_atomic_opcodes()
    print(f"shared atomics in the built kernels: {ops}", flush=True)
    print(json.dumps({"card": card, "t": bib.num_tuples, "designs": rec,
                      "shared_atomics": ops}))
    ok = all(r["bit_equal"] for name, r in rec.items()
             if name not in WRONG_BY_DESIGN)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
