"""Wrappers of the CUDA kernels ``csrc/radix_sort.cu``: the two sweeps of
the 8-bit-digit LSD radix sort of ``core.radix``.

* ``radix_histogram`` — the 256-bucket histograms of every pruned digit of
  1-2 msb-first packed key words, in one sweep.
* ``radix_rank`` — one pass's stable ranks
  ``rank[i] = starts[d_i] + #{j < i : d_j == d_i}``.

The port of ``repro.kernels.radix_sort``; the plain versions are in
``kernels.ref`` and ``kernels.ops`` picks between them.  These wrappers
take CUDA tensors only.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..core.radix import HIST_BUCKETS
from . import build

_NAME = "radix_sort"
_MAX_PASS = 8
_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = build.load(_NAME)
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.radix_histogram_launch.argtypes = [vp, vp, ip, ip, ci, vp, ci,
                                               vp]
        lib.radix_histogram_launch.restype = ci
        lib.radix_rank_launch.argtypes = [vp, vp, vp, vp, ci, vp]
        lib.radix_rank_launch.restype = ci
        lib.radix_rank_scratch_ints.argtypes = [ci]
        lib.radix_rank_scratch_ints.restype = ci
        _argtypes_set = True
    return lib


def _check(x: torch.Tensor, what: str, kernel: str, n: int,
           dev: torch.device):
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"{kernel}: {what} must lie on {dev}, "
                         f"got {x.device}")
    if x.dtype != torch.int32:
        raise ValueError(f"{kernel}: {what} must be int32, got {x.dtype}")
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"{kernel}: {what} must have shape ({n},), "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: {what} must be contiguous")
    if n >= 2**31 - 2**16:
        raise ValueError(f"{kernel}: T={n} exceeds the int32 index")


def radix_histogram(words: Sequence[torch.Tensor], shifts: Sequence[int],
                    widths: Sequence[int]) -> torch.Tensor:
    """words: 1-2 msb-first (T,) int32 words on the card; shifts/widths:
    the plan's digit bit ranges (≤ 8 passes, widths ≤ 8) ->
    (npass, 256) int32 histograms."""
    if len(words) not in (1, 2):
        raise ValueError(f"radix_histogram: 1 or 2 words, got {len(words)}")
    if not words[0].is_cuda:
        raise ValueError("radix_histogram: the CUDA kernel needs CUDA "
                         f"tensors, got {words[0].device}")
    n, dev = words[0].shape[0], words[0].device
    for j, w in enumerate(words):
        _check(w, f"words[{j}]", "radix_histogram", n, dev)
    npass = len(shifts)
    if npass != len(widths) or npass > _MAX_PASS:
        raise ValueError(f"radix_histogram: {npass} shifts, {len(widths)} "
                         f"widths; at most {_MAX_PASS} passes")
    if any(not 1 <= w <= 8 for w in widths) or any(
            s < 0 or s + w > 32 * len(words)
            for s, w in zip(shifts, widths)):
        raise ValueError(f"radix_histogram: digits {list(shifts)} / "
                         f"{list(widths)} do not fit {len(words)} word(s) "
                         "of 8-bit digits")
    out = torch.zeros((npass, HIST_BUCKETS), dtype=torch.int32, device=dev)
    if n == 0 or npass == 0:
        return out
    lib = _lib()
    c_shifts = (ctypes.c_int * _MAX_PASS)(*shifts)
    c_widths = (ctypes.c_int * _MAX_PASS)(*widths)
    hi = words[0].data_ptr() if len(words) == 2 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.radix_histogram_launch(
            hi, words[-1].data_ptr(), c_shifts, c_widths, npass,
            out.data_ptr(), n, stream)
    build.check(lib, _NAME, err, "radix_histogram")
    radix_histogram.launches += 1
    return out


def radix_rank(digits: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """digits (T,) int32 in [0, 256), starts (256,) int32 exclusive bucket
    starts, both on the card -> (T,) int32 stable ranks."""
    if not digits.is_cuda:
        raise ValueError("radix_rank: the CUDA kernel needs CUDA tensors, "
                         f"got {digits.device}")
    n, dev = digits.shape[0], digits.device
    _check(digits, "digits", "radix_rank", n, dev)
    _check(starts, "starts", "radix_rank", HIST_BUCKETS, dev)
    out = torch.empty_like(digits)
    if n == 0:
        return out
    lib = _lib()
    scratch = torch.empty((lib.radix_rank_scratch_ints(n),),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.radix_rank_launch(digits.data_ptr(), starts.data_ptr(),
                                    out.data_ptr(), scratch.data_ptr(), n,
                                    stream)
    build.check(lib, _NAME, err, "radix_rank")
    radix_rank.launches += 1
    return out


#: Launches of each kernel since the last reset (``kernels.ops``).
radix_histogram.launches = 0
radix_rank.launches = 0
