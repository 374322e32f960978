"""Where the time of ``radix_rank``'s one-sweep kernel goes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.probe_radix_rank

Readings at the BibSonomy table's size (T 816,197) on random 44-bit keys
from ``--seed`` (two words), ranking the digit at bits 8..15 with a
random int32 payload: the rank-only entry and the fused pass (words and
payload in, the same scattered out), for

1. ``current``: the kernel as built from ``csrc/radix_sort.cu``, checked
   bit-equal to the plain versions;
2. ``release``: the status words published by ``st.release.gpu`` and a
   ``fence.acq_rel.gpu`` after the look-back, in place of relaxed
   accesses (bit-equal: the count travels in the word);
3. ``match_any``: each element's peers from ``__match_any_sync`` in place
   of the eight digit-bit ballots (bit-equal);
4. ``no_lookback``: every tile publishes INCLUSIVE at once and adds no
   predecessor (rank-only; its ranks are wrong by design): the cost of
   the look-back is ``current − no_lookback``;
5. ``coalesced``: the fused pass writing each element at its own index
   instead of its rank (wrong by design): about what a shared-memory
   reorder before the scatter could reach.

Each time is the mean of ``--iters`` calls timed by CUDA events, queued
behind a sleep kernel, in the order of the list and then back; the
smaller of the two counts.  The last line is one JSON object of every
reading with the card's name and power limit.  Needs the card and
``nvcc``; the variants are built into ``_build/probe`` beside the port's
kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Dict, List, Tuple

from . import build
from .probe_tricluster_density import _build, _time_ms

_SRC = build.CSRC / "radix_sort.cu"
_HEADER = build.CSRC / "lookback.cuh"
_INCLUDE = '#include "lookback.cuh"\n'

_PUBLISH = "    store_relaxed(mine, INCLUSIVE | (unsigned)(prefix + count));\n"
_STORE = "st.relaxed.gpu.global.u64"
_PEERS = "const unsigned peers = peers_of(d[c], valid);"
_TILE0 = "  if (tile == 0) {\n    store_relaxed"
_SCATTER = """        pa.lo_out[rank] = klo[c];
        if (pa.hi_out != nullptr) pa.hi_out[rank] = khi[c];
        pa.perm_out[rank] = pv[c];
"""


def _patched(src: str, edits: List[Tuple[str, str]]) -> str:
    for old, new in edits:
        if src.count(old) < 1:
            raise RuntimeError(f"{old!r} is not in {_SRC} as the probe "
                               "expects: update the probe")
        src = src.replace(old, new)
    return src


def _variants() -> Dict[str, str]:
    src = _SRC.read_text()
    return {
        "release": _patched(src, [
            (_PUBLISH, '    asm volatile("fence.acq_rel.gpu;" ::: "memory");'
                       "\n" + _PUBLISH),
            (_INCLUDE, _patched(_HEADER.read_text(), [
                (_STORE, "st.release.gpu.global.u64")]))]),
        "match_any": _patched(src, [
            (_PEERS, "const unsigned peers = __match_any_sync(FULL_MASK, "
                     "d[c]);")]),
        "no_lookback": _patched(src, [
            (_TILE0, "  if (true) {\n    store_relaxed")]),
        "coalesced": _patched(src, [      # rank kept live in the value
            (_SCATTER, _SCATTER.replace("[rank] = klo[c]",
                                        "[i] = klo[c] + rank")
             .replace("[rank]", "[i]"))]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=816_197)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from ..core.radix import extract_digit
    from . import radix_sort as KR
    from . import ref
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs the card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = _build(_variants())
    rec = {"card": card, "t": args.t,
           "ptxas": {k: v["ptxas"] for k, v in libs.items()}}

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t = args.t
    words = [torch.randint(0, 1 << 12, (t,), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.randint(-2**31, 2**31 - 1, (t,), generator=gen,
                           device=dev, dtype=torch.int32)]
    perm = torch.randperm(t, generator=gen, device=dev).to(torch.int32)
    shift, width = 8, 8
    dig = extract_digit(words, shift, width)
    hist = torch.bincount(dig, minlength=256).to(torch.int32)
    starts = (torch.cumsum(hist, 0, dtype=torch.int32) - hist).contiguous()
    rank_want = ref.radix_rank_ref(dig, starts)
    pass_want = ref.radix_pass_ref(words, perm, shift, width, starts)

    lib = KR._lib()
    scratch = torch.empty((lib.radix_rank_scratch_words(t),),
                          dtype=torch.int64, device=dev)
    rank_out = torch.empty_like(dig)
    w_out = [torch.empty_like(w) for w in words]
    p_out = torch.empty_like(perm)

    def runners(vlib):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        vlib.radix_rank_launch.argtypes = [vp, vp, vp, vp, ci, vp]
        vlib.radix_pass_launch.argtypes = [vp, vp, ci, ci] + [vp] * 6 + [
            ci, vp]

        def rank():
            build.check(vlib, "radix_sort", vlib.radix_rank_launch(
                dig.data_ptr(), starts.data_ptr(), rank_out.data_ptr(),
                scratch.data_ptr(), t,
                torch.cuda.current_stream().cuda_stream))

        def fused():
            build.check(vlib, "radix_sort", vlib.radix_pass_launch(
                words[0].data_ptr(), words[1].data_ptr(), shift, width,
                perm.data_ptr(), starts.data_ptr(), w_out[0].data_ptr(),
                w_out[1].data_ptr(), p_out.data_ptr(), scratch.data_ptr(), t,
                torch.cuda.current_stream().cuda_stream))
        return rank, fused

    runs = {"current": runners(lib)}
    runs.update({k: runners(v["lib"]) for k, v in libs.items()})
    rec["bit_equal"] = {}
    for name, (rank, fused) in runs.items():
        rank()
        fused()
        torch.cuda.synchronize()
        rec["bit_equal"][name] = bool(
            torch.equal(rank_out, rank_want) and torch.equal(
                p_out, pass_want[1]) and all(
                torch.equal(a, b) for a, b in zip(w_out, pass_want[0])))
        print(f"{name}: bit-equal {rec['bit_equal'][name]}; ptxas "
              f"{rec['ptxas'].get(name, 'as built')}", flush=True)
    order = list(runs) + list(reversed(runs))
    times: Dict[str, Dict[str, list]] = {k: {"rank": [], "fused": []}
                                         for k in runs}
    for name in order:
        rank, fused = runs[name]
        for entry, fn in (("rank", rank), ("fused", fused)):
            if (name, entry) == ("no_lookback", "fused"):
                continue       # colliding ranks: its scatter times nothing
            times[name][entry].append(_time_ms(fn, args.iters))
    rec["ms"] = {k: {e: min(v) for e, v in d.items() if v}
                 for k, d in times.items()}
    for name, d in rec["ms"].items():
        print(f"{name}: " + ", ".join(f"{e} {ms * 1e3:.2f} us"
                                      for e, ms in d.items()), flush=True)
    print(json.dumps(rec))
    ok = all(rec["bit_equal"][k] for k in ("current", "release",
                                           "match_any"))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
