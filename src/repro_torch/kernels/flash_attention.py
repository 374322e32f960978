"""Wrapper of the CUDA kernel ``csrc/flash_attention.cu``: causal /
sliding-window GQA flash attention, forward only.

    q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D) -> o (B, Hq, Sq, D)

The port of ``repro.kernels.flash_attention``; the plain version is
``kernels.ref.flash_attention_ref`` and ``kernels.ops.flash_attention``
picks between them.  This wrapper takes contiguous CUDA tensors in fp32 or
bf16 with any head dim, as the Pallas kernel does.  The kernel is
instantiated for every multiple of 16 up to 128 and for 192 and 256
(:data:`HEAD_DIMS`); any other D up to 256 is zero-padded to the next of
them, and any D above 256 to a multiple of 16 (:func:`padded_dim`,
:func:`pad_head_dim`), which runs with O's columns split over the grid,
128 a block, each block computing the whole of S; the output is sliced
back.  The padding is exact in both dtypes: the zero columns add exact
zeros to every score and appear only in the output columns that are cut,
and the scale stays the original D's ``D**-0.5``.  There is no backward
kernel, so it refuses inputs that require a gradient.

The source holds one kernel for each dtype, and the dtype picks it: bf16
runs on the tensor cores (``mma.sync``, bf16 products with fp32 sums, P
rounded to bf16 before the P·V product, K/V tiles by ``cp.async``); fp32
runs on the CUDA cores in fp32 throughout, since no bf16 or TF32
tensor-core product holds fp32's 2e-5 tolerance.  Neither stands in for
the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ..device import record_kernel
from . import build

_NAME = "flash_attention"
#: Head dims the kernel is instantiated for: every multiple of 16 up to
#: 128, and 192 and 256.  Above 256 it runs any multiple of
#: :data:`SPLIT_STEP`, O's columns split over the grid.
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 192, 256)
#: A head dim above :data:`HEAD_DIMS` is zero-padded to a multiple of this.
SPLIT_STEP = 16
#: Query rows a block of either kernel takes.
QUERY_TILE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = build.load(_NAME)
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = (
            [vp] * 4 + [ci] * 11 + [ctypes.c_float, vp])
        lib.flash_attention_launch.restype = ci
        _argtypes_set = True
    return lib


def padded_dim(d: int) -> int:
    """The head dim a call at head dim ``d`` (>= 1) runs at: the least of
    :data:`HEAD_DIMS` at or above it, else ``d`` rounded up to a multiple
    of :data:`SPLIT_STEP`."""
    return min((x for x in HEAD_DIMS if x >= d),
               default=-(-d // SPLIT_STEP) * SPLIT_STEP)


def pad_head_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x`` with zero columns appended to its last axis up to ``d`` (a
    fresh contiguous tensor), or ``x`` itself when it has ``d``."""
    return x if x.shape[-1] == d else F.pad(x, (0, d - x.shape[-1]))


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """The rules on the operands' dtypes, shapes and gradients that the
    card refuses a call by; :func:`meta` applies them too, so a dry trace
    refuses what the card refuses."""
    if any(x.requires_grad for x in (q, k, v)):
        raise ValueError("flash_attention: there is no backward kernel; "
                         "call it on tensors that do not require a gradient "
                         "(for example under torch.no_grad())")
    for x, what in ((k, "k"), (v, "v")):
        if x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {what} must be {q.dtype}, "
                             f"got {x.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B,Hq,Sq,D) and k, v "
                         f"(B,Hkv,Skv,D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch or head dim")
    if k.shape[1] == 0 or hq % k.shape[1] != 0:
        raise ValueError(f"flash_attention: Hq={hq} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    if d < 1:
        raise ValueError(f"flash_attention: head dim {d} not supported "
                         "(1 or more)")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: no keys (Skv = 0)")
    if -(-q.shape[2] // QUERY_TILE) >= 2**16:
        raise ValueError(f"flash_attention: Sq={q.shape[2]} exceeds the "
                         "grid")
    dp = padded_dim(d)
    for x, what in ((q, "q"), (k, "k"), (v, "v")):
        if x.numel() // d * dp >= 2**31:
            raise ValueError(f"flash_attention: {what} exceeds the int32 "
                             "index")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    check_shapes(q, k, v)
    for x, what in ((q, "q"), (k, "k"), (v, "v")):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {what} must be contiguous")
    if not q.is_cuda:
        raise ValueError("flash_attention: the CUDA kernel needs CUDA "
                         f"tensors, got {q.device}")
    for x, what in ((k, "k"), (v, "v")):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {what} must lie on "
                             f"{q.device}, got {x.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention computed on the card; ``q_offset`` (the key position of
    q row 0) defaults to Skv - Sq and ``scale`` to D**-0.5.  A head dim
    runs zero-padded to :func:`padded_dim`'s."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q_offset is None:
        q_offset = skv - sq
    if scale is None:
        scale = d ** -0.5
    dp = padded_dim(d)
    q, k, v = (pad_head_dim(x, dp) for x in (q, k, v))
    if q.dtype == torch.bfloat16:
        # the bf16 kernel copies 16-byte chunks: a view that starts off a
        # 16-byte boundary is copied to a fresh (aligned) allocation
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
                   for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, skv, dp, _DTYPES[q.dtype], int(bool(causal)),
            int(window is not None), int(window or 0), int(q_offset),
            float(scale), stream)
    build.check(lib, _NAME, err)
    flash_attention.launches += 1
    return out if dp == d else out[..., :d].contiguous()


#: Launches of the kernel since the last reset (``kernels.ops``).
flash_attention.launches = 0


def pairs(sq: int, skv: int, causal: bool = True,
          window: Optional[int] = None,
          q_offset: Optional[int] = None) -> int:
    """The (query, key) pairs a call attends: query row i sits at key
    position ``q_offset + i`` (default Skv - Sq) and sees the keys at or
    before it when ``causal``, and after ``position - window`` with a
    window."""
    import numpy as np
    pos = np.arange(sq, dtype=np.int64) + (skv - sq if q_offset is None
                                           else q_offset)
    hi = np.clip(pos + 1, 0, skv) if causal else np.full(sq, skv)
    lo = np.clip(pos - window + 1, 0, skv) if window else np.zeros(sq)
    return int(np.maximum(hi - lo, 0).sum())


def work(q_shape, kv_shape, elt: int, causal: bool = True,
         window: Optional[int] = None,
         q_offset: Optional[int] = None) -> tuple:
    """(bytes, tensor-core operations) of one call: q, k and v read once
    and the output written once, and two products of 2·D operations for
    every attended (query, key) pair and query head, at the head dim the
    kernel runs (a padded D where the call pads)."""
    b, hq, sq, d = q_shape
    d = padded_dim(d)
    hkv, skv = kv_shape[1], kv_shape[2]
    nbytes = elt * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)
    return nbytes, 4 * b * hq * pairs(sq, skv, causal, window, q_offset) * d


def meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: Optional[int] = None,
         q_offset: Optional[int] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """The dry trace's :func:`flash_attention`: its output on ``meta``,
    one recorded call; it refuses what the card refuses
    (:func:`check_shapes`)."""
    check_shapes(q, k, v)
    out = torch.empty_like(q)
    if out.numel():
        record_kernel(_NAME, *work(q.shape, k.shape, q.element_size(),
                                   causal, window, q_offset), tensor=True)
    return out
