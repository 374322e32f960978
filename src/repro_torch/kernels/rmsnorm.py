"""Wrapper of the CUDA kernels ``csrc/rmsnorm.cu``: RMSNorm over the last
axis, fp32 statistics, output in x's dtype.

    x (R, D), w (D,) -> x · rsqrt(mean(x²) + eps) · w

The port of ``repro.kernels.rmsnorm``; the plain version is
``kernels.ref.rmsnorm_ref`` and ``kernels.ops.rmsnorm`` picks between them
(and folds any leading shape into R).  This wrapper takes CUDA tensors: a
contiguous (R, D) x and a (D,) w, each fp32 or bf16, any R (nothing is
padded).  There is no backward kernel, so it refuses inputs that require
a gradient.

The source has three kernels, and :func:`plan` picks one from the call's
width, dtypes and alignment: the 16-byte register path (``vector``) where
it applies, else a warp per row (``warp``) or a block per row (``block``).
Its constants are held against the built kernel's (:func:`kernel_config`)
when the library is loaded, and the C entry refuses a plan that does not
fit its arguments.  Each path is one launch in ``rmsnorm.launches``, and
``rmsnorm.path_launches`` counts them by path.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict

import torch

from ..device import record_kernel
from . import build

_NAME = "rmsnorm"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"vector": 0, "warp": 1, "block": 2}
_checked = False

#: Threads of a block, every kernel.
THREADS = 256
#: Widest row of the warp-per-row kernel; wider rows off the vector path
#: take a block each.
WARP_MAX_D = 1024
#: Widest row of the vector kernel: x and the fp32 weight stay in
#: registers up to it.
VEC_MAX_D = 1536
#: Bytes of one vector load or store.
VEC_BYTES = 16
#: Blocks per SM of the vector kernel's persistent grid.
VEC_BLOCKS_PER_SM = 2
#: The vectors a lane may hold (the kernel's instantiations).
LANE_VECTORS = (1, 2, 3, 4, 6, 8, 12)


@dataclass(frozen=True)
class Plan:
    """The kernel a call launches: ``path`` is ``vector``, ``warp`` or
    ``block``; ``lane_vectors`` the 16-byte vectors a lane holds (vector
    path only, else 0)."""
    path: str
    lane_vectors: int = 0


def plan(d: int, x_dtype: torch.dtype, aligned: bool) -> Plan:
    """The path of rows of ``d`` elements of ``x_dtype`` (with a weight of
    either dtype); ``aligned``: x, w and the output start on 16-byte
    boundaries.  The vector path takes rows whose bytes are a multiple of
    16, up to ``VEC_MAX_D``; a lane then holds the first count of
    ``LANE_VECTORS`` whose 32 lanes cover the row's vectors."""
    es = x_dtype.itemsize
    if aligned and (d * es) % VEC_BYTES == 0 and d <= VEC_MAX_D:
        nvec = d * es // VEC_BYTES
        return Plan("vector", next(k for k in LANE_VECTORS
                                   if 32 * k >= nvec))
    return Plan("warp" if d <= WARP_MAX_D else "block")


def plan_for(x: torch.Tensor, w: torch.Tensor) -> Plan:
    """:func:`plan` of a call on ``x`` and ``w`` (the output is allocated
    aligned)."""
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x, w))
    return plan(x.shape[-1], x.dtype, aligned)


_CONFIG_KEYS = ("threads", "warp_max_d", "vec_max_d", "vec_bytes",
                "vec_blocks_per_sm", "n_lane_vectors")


def _config(lib: ctypes.CDLL) -> Dict[str, object]:
    out = (ctypes.c_int64 * 16)()
    build.check(lib, _NAME, lib.rmsnorm_config(ctypes.addressof(out)))
    cfg = dict(zip(_CONFIG_KEYS, out))
    n = len(_CONFIG_KEYS)
    cfg["lane_vectors"] = tuple(out[n:n + cfg["n_lane_vectors"]])
    return cfg


def _lib() -> ctypes.CDLL:
    """The loaded library; on first use its constants are held against
    the plan's."""
    global _checked
    lib = build.load(_NAME)
    if not _checked:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.argtypes = [vp, vp, vp, ctypes.c_int64, ci, ci,
                                       ci, ctypes.c_float, ci, ci, vp]
        lib.rmsnorm_launch.restype = ci
        lib.rmsnorm_config.argtypes = [vp]
        lib.rmsnorm_config.restype = ci
        cfg = _config(lib)
        got = (cfg["threads"], cfg["warp_max_d"], cfg["vec_max_d"],
               cfg["vec_bytes"], cfg["vec_blocks_per_sm"],
               cfg["lane_vectors"])
        want = (THREADS, WARP_MAX_D, VEC_MAX_D, VEC_BYTES,
                VEC_BLOCKS_PER_SM, LANE_VECTORS)
        if got != want:
            raise RuntimeError(
                "rmsnorm: the kernel's THREADS, WARP_MAX_D, VEC_MAX_D, "
                "VEC_BYTES, VEC_BLOCKS_PER_SM, LANE_VECTORS are "
                f"{got}, the plan's {want}")
        _checked = True
    return lib


def kernel_config() -> Dict[str, object]:
    """The built kernel's constants, as :func:`plan` reads them."""
    return _config(_lib())


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
    p = plan_for(x, w)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                 r, d, _DTYPES[x.dtype], _DTYPES[w.dtype],
                                 float(eps), _PATHS[p.path], p.lane_vectors,
                                 stream)
    build.check(lib, _NAME, err, f"rmsnorm ({p.path} path)")
    rmsnorm.launches += 1
    rmsnorm.path_launches[p.path] += 1
    return out


#: Launches of the kernels since the last reset (``kernels.ops``), and
#: since the module was loaded by path (read as differences).
rmsnorm.launches = 0
rmsnorm.path_launches = dict.fromkeys(_PATHS, 0)


def work(rows: int, d: int, elt: int, w_elt: int = 4) -> tuple:
    """(bytes, operations) of one call: x read and the output written
    once in x's dtype, the weight read once; four operations an
    element."""
    return 2 * elt * rows * d + w_elt * d, 4 * rows * d


def meta(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
         ) -> torch.Tensor:
    """The dry trace's :func:`rmsnorm` on (R, D): its output on ``meta``,
    one recorded call."""
    out = torch.empty_like(x)
    if x.shape[0]:
        record_kernel(_NAME, *work(x.shape[0], x.shape[1], x.element_size(),
                                   w.element_size()))
    return out
