"""Wrapper of the CUDA kernel ``csrc/rmsnorm.cu``: RMSNorm over the last
axis, fp32 statistics, output in x's dtype.

    x (R, D), w (D,) -> x · rsqrt(mean(x²) + eps) · w

The port of ``repro.kernels.rmsnorm``; the plain version is
``kernels.ref.rmsnorm_ref`` and ``kernels.ops.rmsnorm`` picks between them
(and folds any leading shape into R).  This wrapper takes CUDA tensors: a
contiguous (R, D) x and a (D,) w, each fp32 or bf16, any R (nothing is
padded).  There is no backward kernel, so it refuses inputs that require
a gradient.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_NAME = "rmsnorm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = build.load(_NAME)
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.argtypes = [vp, vp, vp, ctypes.c_int64, ci, ci,
                                       ci, ctypes.c_float, vp]
        lib.rmsnorm_launch.restype = ci
        _argtypes_set = True
    return lib


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (R, D) and w (D,) on the card -> (R, D) in x's dtype, computed on
    the card."""
    if x.requires_grad or w.requires_grad:
        raise ValueError("rmsnorm: there is no backward kernel; call it on "
                         "tensors that do not require a gradient (for "
                         "example under torch.no_grad())")
    if x.dim() != 2 or w.dim() != 1 or w.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm: x (R, D) and w (D,) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    for t, what in ((x, "x"), (w, "w")):
        if t.dtype not in _DTYPES:
            raise ValueError(f"rmsnorm: {what} dtype {t.dtype} not "
                             "supported (float32 or bfloat16)")
        if t.device != x.device:
            raise ValueError(f"rmsnorm: {what} must lie on {x.device}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"rmsnorm: {what} must be contiguous")
    r, d = x.shape
    if d == 0 or d >= 2**31 or r >= 2**31:
        raise ValueError(f"rmsnorm: shape {tuple(x.shape)} not supported "
                         "(0 < D < 2**31, R < 2**31)")
    if not x.is_cuda:
        raise ValueError("rmsnorm: the CUDA kernel needs CUDA tensors, got "
                         f"{x.device}")
    out = torch.empty_like(x)
    if r == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 r, d, _DTYPES[x.dtype], _DTYPES[w.dtype],
                                 float(eps), stream)
    build.check(lib, _NAME, err)
    rmsnorm.launches += 1
    return out


#: Launches of the kernel since the last reset (``kernels.ops``).
rmsnorm.launches = 0
