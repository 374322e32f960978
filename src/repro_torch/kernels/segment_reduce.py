"""Wrapper of the CUDA kernel ``csrc/segment_reduce.cu``: fused masked
prefix sums for Stage-2 segment reductions.

    ex_lo[i]  = Σ_{j<i} first[j] ? w_lo[j] : 0      (mod 2³²)
    ex_hi[i]  = Σ_{j<i} first[j] ? w_hi[j] : 0      (mod 2³²)
    ex_cnt[i] = Σ_{j<i} first[j]                     for i in [0, T]

The kernel writes these exclusive (T + 1,) sums, the layout
``core.pipeline.masked_prefix`` reads (:func:`segment_reduce_exclusive`);
:func:`segment_reduce` returns the inclusive (T,) sums as their views
``ex[1:]``.  One call is one memset of the scratch and one launch: a
single sweep with decoupled look-back over tiles of ``TILE`` elements
(``ref.segment_reduce_tiled`` emulates its tile plan).

The port of ``repro.kernels.segment_reduce``; the plain version is
``kernels.ref.segment_reduce_ref`` and ``kernels.ops`` picks between them.
This wrapper takes CUDA tensors only.  :func:`plan` picks the 16-byte load
path or the scalar one from the inputs' alignment; the constants are held
against the built kernel's (:func:`kernel_config`) when the library is
loaded.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..device import record_kernel
from . import build

_NAME = "segment_reduce"
_PATHS = {"scalar": 0, "vector": 1}
_checked = False

#: Threads of a block, contiguous elements a thread owns, and elements of
#: a tile (one block's share of the sweep).
THREADS = 256
ITEMS = 16
TILE = THREADS * ITEMS
#: Status words a tile publishes (one per lane: lo, hi, count), and the
#: predecessor words a look-back warp reads at once.
LANES = 3
LOOKBACK = 32
#: Bytes of one vector load.
VEC_BYTES = 16


@dataclass(frozen=True)
class Plan:
    """The sweep a call launches: ``path`` is ``vector`` (16-byte loads)
    or ``scalar`` (one load an element); ``tiles`` the blocks, one tile
    each."""
    path: str
    tiles: int


def plan(n: int, aligned: bool) -> Plan:
    """The sweep over ``n`` elements; ``aligned``: w_lo, w_hi and first
    all start on 16-byte boundaries, so a thread's run of ``ITEMS``
    elements is four 16-byte loads of each weight lane and one of the
    flags.  A run that ``n`` cuts is read one element at a time on either
    path."""
    return Plan("vector" if aligned else "scalar", -(-n // TILE))


_CONFIG_KEYS = ("threads", "items", "tile", "lanes", "lookback",
                "registers", "local_bytes")


def _config(lib: ctypes.CDLL, vector: bool) -> Dict[str, int]:
    out = (ctypes.c_int64 * len(_CONFIG_KEYS))()
    build.check(lib, _NAME, lib.segment_reduce_config(
        int(vector), ctypes.addressof(out)))
    return dict(zip(_CONFIG_KEYS, out))


def _lib() -> ctypes.CDLL:
    """The loaded library; on first use its constants are held against
    this module's."""
    global _checked
    lib = build.load(_NAME)
    if not _checked:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.segment_reduce_launch.argtypes = [vp] * 7 + [ci, ci, vp]
        lib.segment_reduce_launch.restype = ci
        lib.segment_reduce_scratch_ints.argtypes = [ci]
        lib.segment_reduce_scratch_ints.restype = ci
        lib.segment_reduce_config.argtypes = [ci, vp]
        lib.segment_reduce_config.restype = ci
        cfg = _config(lib, True)
        got = tuple(cfg[k] for k in _CONFIG_KEYS[:5])
        want = (THREADS, ITEMS, TILE, LANES, LOOKBACK)
        if got != want:
            raise RuntimeError(
                "segment_reduce: the kernel's TPB, ITEMS, TILE, LANES, "
                f"LOOKBACK are {got}, this module's {want}")
        for n in (1, TILE, TILE + 1, 816_197):
            if lib.segment_reduce_scratch_ints(n) != scratch_ints(n):
                raise RuntimeError(
                    f"segment_reduce: the kernel's scratch for T={n} is "
                    f"{lib.segment_reduce_scratch_ints(n)} int32 words, "
                    f"this module's {scratch_ints(n)}")
        _checked = True
    return lib


def kernel_config(vector: bool = True) -> Dict[str, int]:
    """The built sweep's constants (``threads``, ``items``, ``tile``,
    ``lanes``, ``lookback``) and, for the ``vector`` or scalar variant,
    its ``registers`` and ``local_bytes`` a thread."""
    return _config(_lib(), vector)


def _check_lane(x: torch.Tensor, what: str, n: int, dev: torch.device):
    if not x.is_cuda or x.device != dev:
        raise ValueError(f"segment_reduce: {what} must lie on {dev}, "
                         f"got {x.device}")
    if x.dim() != 1 or x.shape[0] != n:
        raise ValueError(f"segment_reduce: {what} must have shape ({n},), "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"segment_reduce: {what} must be contiguous")


def scratch_ints(n: int) -> int:
    """int32 words of scratch a launch over ``n`` elements needs: the tile
    counter and ``LANES`` status words a tile, 64 bits each (the C entry
    ``segment_reduce_scratch_ints``, held against this at load)."""
    return 2 * (1 + LANES * -(-n // TILE))


def segment_reduce_exclusive(w_lo: torch.Tensor, w_hi: torch.Tensor,
                             first: torch.Tensor
                             ) -> Tuple[torch.Tensor, ...]:
    """w_lo/w_hi (T,) int32 (uint32 bit patterns), first (T,) bool ->
    three (T + 1,) int32 exclusive masked prefix sums, computed on the
    card (element 0 is 0, element T the total).  A non-bool ``first`` is
    taken as ``first != 0``."""
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
    if n == 0:
        return tuple(torch.zeros((1,), dtype=torch.int32, device=dev)
                     for _ in range(3))
    out = tuple(torch.empty((n + 1,), dtype=torch.int32, device=dev)
                for _ in range(3))
    scratch = torch.empty((scratch_ints(n),), dtype=torch.int32, device=dev)
    lib = _lib()
    p = plan(n, (w_lo.data_ptr() | w_hi.data_ptr() | first.data_ptr())
             % VEC_BYTES == 0)
    with build.on_device(dev):
        err = lib.segment_reduce_launch(
            w_lo.data_ptr(), w_hi.data_ptr(), first.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            scratch.data_ptr(), n, _PATHS[p.path],
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, _NAME, err, f"segment_reduce ({p.path} path)")
    segment_reduce.launches += 1
    return out


def segment_reduce(w_lo: torch.Tensor, w_hi: torch.Tensor,
                   first: torch.Tensor):
    """w_lo/w_hi (T,) int32 (uint32 bit patterns), first (T,) bool ->
    three (T,) int32 inclusive masked prefix sums, computed on the card
    (views of :func:`segment_reduce_exclusive`'s sums past element 0).
    A non-bool ``first`` is taken as ``first != 0``."""
    return tuple(x[1:] for x in segment_reduce_exclusive(w_lo, w_hi,
                                                         first))


def work(n: int, exclusive: bool = True) -> Tuple[int, int]:
    """(bytes, operations) of one call over ``n`` elements: both weight
    lanes and the flags read once, the three int32 sums written once
    ((n + 1) each in the exclusive layout), three adds an element."""
    return 9 * n + 12 * (n + int(exclusive)), 3 * n


def meta_exclusive(w_lo: torch.Tensor, w_hi: torch.Tensor,
                   first: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The dry trace's :func:`segment_reduce_exclusive`: its outputs and
    scratch on ``meta``, one recorded call (``device.record_kernel``)."""
    n = w_lo.shape[0]
    out = tuple(torch.empty((n + 1,), dtype=torch.int32, device=w_lo.device)
                for _ in range(3))
    if n:
        torch.empty((scratch_ints(n),), dtype=torch.int32,
                    device=w_lo.device)
        record_kernel(_NAME, *work(n))
    return out


#: Launches of the kernel since the last reset (``kernels.ops``); both
#: entries count here.
segment_reduce.launches = 0
