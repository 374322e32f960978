"""Wrapper of the CUDA kernel ``csrc/segment_reduce.cu``: fused masked
prefix sums for Stage-2 segment reductions.

    out_lo[i]  = Σ_{j<=i} first[j] ? w_lo[j] : 0      (mod 2³²)
    out_hi[i]  = Σ_{j<=i} first[j] ? w_hi[j] : 0      (mod 2³²)
    out_cnt[i] = Σ_{j<=i} first[j]

The port of ``repro.kernels.segment_reduce``; the plain version is
``kernels.ref.segment_reduce_ref`` and ``kernels.ops.segment_reduce``
picks between them.  This wrapper takes CUDA tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_NAME = "segment_reduce"
_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = build.load(_NAME)
    if not _argtypes_set:
        lib.segment_reduce_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p])
        lib.segment_reduce_launch.restype = ctypes.c_int
        lib.segment_reduce_scratch_ints.argtypes = [ctypes.c_int]
        lib.segment_reduce_scratch_ints.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def _check_lane(x: torch.Tensor, what: str, n: int, dev: torch.device):
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"segment_reduce: {what} must lie on {dev}, "
                         f"got {x.device}")
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"segment_reduce: {what} must have shape ({n},), "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"segment_reduce: {what} must be contiguous")


def segment_reduce(w_lo: torch.Tensor, w_hi: torch.Tensor,
                   first: torch.Tensor):
    """w_lo/w_hi (T,) int32 (uint32 bit patterns), first (T,) bool ->
    three (T,) int32 inclusive masked prefix sums, computed on the card.
    A non-bool ``first`` is taken as ``first != 0``."""
    if not w_lo.is_cuda:
        raise ValueError("segment_reduce: the CUDA kernel needs CUDA "
                         f"tensors, got {w_lo.device}")
    n, dev = w_lo.shape[0], w_lo.device
    for x, what in ((w_lo, "w_lo"), (w_hi, "w_hi")):
        _check_lane(x, what, n, dev)
        if x.dtype != torch.int32:
            raise ValueError(f"segment_reduce: {what} must be int32, "
                             f"got {x.dtype}")
    if first.dtype != torch.bool:
        first = first != 0
    _check_lane(first, "first", n, dev)
    if n >= 2**31 - 2**16:
        raise ValueError(f"segment_reduce: T={n} exceeds the int32 index")
    out_lo = torch.empty_like(w_lo)
    out_hi = torch.empty_like(w_lo)
    out_cnt = torch.empty_like(w_lo)
    if n == 0:
        return out_lo, out_hi, out_cnt
    lib = _lib()
    scratch = torch.empty((lib.segment_reduce_scratch_ints(n),),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_reduce_launch(
            w_lo.data_ptr(), w_hi.data_ptr(), first.data_ptr(),
            out_lo.data_ptr(), out_hi.data_ptr(), out_cnt.data_ptr(),
            scratch.data_ptr(), n, stream)
    build.check(lib, _NAME, err)
    segment_reduce.launches += 1
    return out_lo, out_hi, out_cnt


#: Launches of the kernel since the last reset (``kernels.ops``).
segment_reduce.launches = 0
