"""Wrapper of the CUDA kernel ``csrc/signature.cu``: order-independent set
signatures of 0/1 mask rows.

    sig[t] = Σ_e mask[t, e] · r[e]      (mod 2³²)

The port of ``repro.kernels.signature``; the plain version is
``kernels.ref.signature_ref`` and ``kernels.ops.set_signature`` picks
between them.  This wrapper takes CUDA tensors only: a contiguous (T, E)
bool or uint8 mask and a (E,) int32 ``r`` of uint32 bit patterns.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import record_kernel
from . import build

_NAME = "signature"
_MASK_DTYPES = (torch.bool, torch.uint8)
_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = build.load(_NAME)
    if not _argtypes_set:
        vp = ctypes.c_void_p
        lib.signature_launch.argtypes = [vp, vp, vp, ctypes.c_int64,
                                         ctypes.c_int64, vp]
        lib.signature_launch.restype = ctypes.c_int
        _argtypes_set = True
    return lib


def signature(mask: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """mask (T, E) bool/uint8 0/1 and r (E,) int32 on the card -> (T,)
    int32 signatures (uint32 bit patterns), computed on the card."""
    if not mask.is_cuda:
        raise ValueError("signature: the CUDA kernel needs CUDA tensors, "
                         f"got {mask.device}")
    dev = mask.device
    if mask.dim() != 2:
        raise ValueError(f"signature: mask must be (T, E), got "
                         f"{tuple(mask.shape)}")
    t, e = mask.shape
    if mask.dtype not in _MASK_DTYPES:
        raise ValueError(f"signature: mask must be bool or uint8, got "
                         f"{mask.dtype}")
    if r.device != dev:
        raise ValueError(f"signature: r must lie on {dev}, got {r.device}")
    if r.dtype != torch.int32 or r.shape != (e,):
        raise ValueError(f"signature: r must be ({e},) int32, got "
                         f"{tuple(r.shape)} {r.dtype}")
    if not (mask.is_contiguous() and r.is_contiguous()):
        raise ValueError("signature: mask and r must be contiguous")
    out = torch.empty((t,), dtype=torch.int32, device=dev)
    if t == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.signature_launch(mask.data_ptr(), r.data_ptr(),
                                   out.data_ptr(), t, e, stream)
    build.check(lib, _NAME, err)
    signature.launches += 1
    return out


#: Launches of the kernel since the last reset (``kernels.ops``).
signature.launches = 0


def work(t: int, e: int) -> tuple:
    """(bytes, operations) of one call: the (T, E) byte mask and r read
    once, the signatures written once; a multiply and an add an
    element."""
    return t * e + 4 * e + 4 * t, 2 * t * e


def meta(mask: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The dry trace's :func:`signature`: its output on ``meta``, one
    recorded call."""
    t, e = mask.shape
    out = torch.empty((t,), dtype=torch.int32, device=mask.device)
    if t:
        record_kernel(_NAME, *work(t, e))
    return out
