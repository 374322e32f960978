"""Wrapper of the CUDA kernel ``csrc/tricluster_density.cu``: exact
tricluster density numerators (box counts).

    num[t] = Σ_{g,m,b} X[t,g]·Y[t,m]·Z[t,b]·I[g,m,b]

The port of ``repro.kernels.tricluster_density``; the plain version is
``kernels.ref.tricluster_density_ref`` and ``kernels.ops`` picks between
them.  This wrapper takes CUDA tensors only: a contiguous (G, M, B) tensor
and (T, G), (T, M), (T, B) masks, each bool or uint8 and 0/1.  They are
read as they are (no float copy).  The result is (T,) float32, exact for
counts below 2**24.

The kernel computes ``C[t, n] = Σ_m Y[t,m]·I'[n,m]`` on the int8 tensor
cores, with ``n = g·B + b`` and ``I'`` the tensor laid out K-major in
scratch, and weights each C value by ``X[t,g]·Z[t,b]`` in its epilogue:
:class:`Plan` states that decomposition (padding, tiles, raster order,
scratch size, the column → (g, b) map) in Python, and
``kernels.ref.tricluster_density_tiled`` emulates it on any device.  The
plan's constants are held against the built kernel's
(:func:`kernel_config`) when the library is loaded.  One call is one
launch in ``tricluster_density.launches``, though it runs three CUDA
kernels (the ``I'`` layout, the tiles, the float conversion).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..device import record_kernel
from . import build

_NAME = "tricluster_density"
_DTYPES = (torch.bool, torch.uint8)
_checked = False

#: Rows t and columns n of one block's output tile.
TILE_T = 128
TILE_N = 128
#: Bytes of m per stage of the kernel's cp.async ring, and its depth.
K_CHUNK = 128
STAGES = 3
#: t-tiles per raster group: block ids run over a group's t-tiles for one
#: n-tile, then the next n-tile.
GROUP_T = 16


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


@dataclass(frozen=True)
class Plan:
    """The kernel's decomposition of a (T, G, M, B) call."""
    t: int
    g: int
    m: int
    b: int

    @property
    def n(self) -> int:
        """Columns n = g·B + b of the product."""
        return self.g * self.b

    @property
    def kp(self) -> int:
        """M rounded up to a whole K chunk: the row length of I'."""
        return _round_up(self.m, K_CHUNK)

    @property
    def n_pad(self) -> int:
        """N rounded up to a whole n-tile: the rows of I'."""
        return _round_up(self.n, TILE_N)

    @property
    def tiles_t(self) -> int:
        return -(-self.t // TILE_T)

    @property
    def tiles_n(self) -> int:
        return self.n_pad // TILE_N

    @property
    def blocks(self) -> int:
        return self.tiles_t * self.tiles_n

    @property
    def chunks(self) -> int:
        """Steps of the K loop."""
        return self.kp // K_CHUNK

    @property
    def image_bytes(self) -> int:
        return self.n_pad * self.kp

    @property
    def scratch_words(self) -> int:
        """int32 words of scratch: the I' image, then T uint64 row sums."""
        return self.image_bytes // 4 + 2 * self.t

    def tile(self, pid: int) -> Tuple[int, int]:
        """(t-tile, n-tile) of block ``pid`` in the raster order."""
        per_group = GROUP_T * self.tiles_n
        group, local = divmod(pid, per_group)
        first = group * GROUP_T
        gsize = min(self.tiles_t - first, GROUP_T)
        return first + local % gsize, local // gsize

    def column(self, n: int) -> Tuple[int, int]:
        """(g, b) of product column n."""
        return divmod(n, self.b)


def plan(t: int, g: int, m: int, b: int) -> Plan:
    return Plan(int(t), int(g), int(m), int(b))


_CONFIG_KEYS = ("tile_t", "tile_n", "k_chunk", "stages", "group_t",
                "smem_bytes", "registers", "local_bytes")


def _config(lib: ctypes.CDLL, aligned: bool) -> Dict[str, int]:
    out = (ctypes.c_int64 * len(_CONFIG_KEYS))()
    build.check(lib, _NAME, lib.tricluster_density_config(
        int(aligned), ctypes.addressof(out)))
    return dict(zip(_CONFIG_KEYS, out))


def _lib() -> ctypes.CDLL:
    """The loaded library; on first use its tile constants are held
    against the plan's."""
    global _checked
    lib = build.load(_NAME)
    if not _checked:
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.tricluster_density_launch.argtypes = [vp] * 6 + [i64] * 4 + [vp]
        lib.tricluster_density_launch.restype = ctypes.c_int
        lib.tricluster_density_scratch_words.argtypes = [i64] * 3
        lib.tricluster_density_scratch_words.restype = i64
        lib.tricluster_density_config.argtypes = [ctypes.c_int, vp]
        lib.tricluster_density_config.restype = ctypes.c_int
        cfg = _config(lib, True)
        got = tuple(cfg[k] for k in _CONFIG_KEYS[:5])
        want = (TILE_T, TILE_N, K_CHUNK, STAGES, GROUP_T)
        if got != want:
            raise RuntimeError(
                "tricluster_density: the kernel's TILE_T, TILE_N, K_CHUNK, "
                f"STAGES, GROUP_T are {got}, the plan's {want}")
        _checked = True
    return lib


def kernel_config(aligned: bool = True) -> Dict[str, int]:
    """The built tile kernel's constants (``tile_t`` .. ``group_t``), the
    dynamic shared memory a launch asks for (``smem_bytes``) and, from the
    CUDA runtime, the ``registers`` and ``local_bytes`` a thread of the
    variant loaded (Y by ``cp.async`` when ``aligned``, else by byte
    loads)."""
    return _config(_lib(), aligned)


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
    # the I' image, then t uint64 row sums
    words = lib.tricluster_density_scratch_words(g, m, b) + 2 * t
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
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


def work(t: int, g: int, m: int, b: int) -> Tuple[int, int]:
    """(bytes, tensor-core operations) of one call: the (G, M, B) byte
    tensor and the three masks read once, the float32 numerators written
    once; a multiply and an add for every (tricluster, cell) pair."""
    return g * m * b + t * (g + m + b) + 4 * t, 2 * t * g * m * b


def meta(tensor: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
         z: torch.Tensor) -> torch.Tensor:
    """The dry trace's :func:`tricluster_density`: its output on
    ``meta``, one recorded call."""
    g, m, b = tensor.shape
    t = x.shape[0]
    out = torch.empty((t,), dtype=torch.float32, device=tensor.device)
    if t:
        record_kernel(_NAME, *work(t, g, m, b), tensor=True)
    return out
