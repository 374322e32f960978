"""Wrapper of the CUDA kernel ``csrc/tricluster_density.cu``: exact
tricluster density numerators (box counts).

    num[t] = Σ_{g,m,b} X[t,g]·Y[t,m]·Z[t,b]·I[g,m,b]

The port of ``repro.kernels.tricluster_density``; the plain version is
``kernels.ref.tricluster_density_ref`` and ``kernels.ops`` picks between
them.  This wrapper takes CUDA tensors only: a contiguous (G, M, B) tensor
and (T, G), (T, M), (T, B) masks, each bool or uint8 and 0/1.  They are
read as they are (no float copy).  The result is (T,) float32, exact for
counts below 2**24.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_NAME = "tricluster_density"
_DTYPES = (torch.bool, torch.uint8)
_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = build.load(_NAME)
    if not _argtypes_set:
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.tricluster_density_launch.argtypes = [vp] * 6 + [i64] * 4 + [vp]
        lib.tricluster_density_launch.restype = ctypes.c_int
        lib.tricluster_density_scratch_words.argtypes = [i64] * 3
        lib.tricluster_density_scratch_words.restype = i64
        _argtypes_set = True
    return lib


def _check(a: torch.Tensor, what: str, shape, dev: torch.device) -> None:
    if a.device != dev:
        raise ValueError(f"tricluster_density: {what} must lie on {dev}, "
                         f"got {a.device}")
    if a.dtype not in _DTYPES:
        raise ValueError(f"tricluster_density: {what} must be bool or "
                         f"uint8, got {a.dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"tricluster_density: {what} must have shape "
                         f"{tuple(shape)}, got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"tricluster_density: {what} must be contiguous")


def tricluster_density(tensor: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """tensor (G, M, B) and masks x (T, G), y (T, M), z (T, B), all 0/1
    bool/uint8 on the card -> (T,) float32 numerators, computed on the
    card."""
    if not tensor.is_cuda:
        raise ValueError("tricluster_density: the CUDA kernel needs CUDA "
                         f"tensors, got {tensor.device}")
    dev = tensor.device
    if tensor.dim() != 3 or x.dim() != 2:
        raise ValueError("tricluster_density: tensor must be (G, M, B) and "
                         f"x (T, G), got {tuple(tensor.shape)} and "
                         f"{tuple(x.shape)}")
    g, m, b = tensor.shape
    t = x.shape[0]
    _check(tensor, "tensor", (g, m, b), dev)
    for a, what, n in ((x, "x", g), (y, "y", m), (z, "z", b)):
        _check(a, what, (t, n), dev)
    out = torch.empty((t,), dtype=torch.float32, device=dev)
    if t == 0:
        return out
    lib = _lib()
    scratch = torch.empty(
        (max(1, lib.tricluster_density_scratch_words(g, m, b)),),
        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tricluster_density_launch(
            tensor.data_ptr(), x.data_ptr(), y.data_ptr(), z.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), t, g, m, b, stream)
    build.check(lib, _NAME, err)
    tricluster_density.launches += 1
    return out


#: Launches of the kernel since the last reset (``kernels.ops``).
tricluster_density.launches = 0
