"""Wrappers of the CUDA kernels ``csrc/radix_sort.cu``: the two sweeps of
the 8-bit-digit LSD radix sort of ``core.radix``.

* ``radix_histogram`` — the 256-bucket histograms of every pruned digit of
  1-2 msb-first packed key words, in one sweep: one memset of the output
  and one launch on a persistent grid, which :func:`hist_plan` sizes from
  the SM count and sets to 16-byte loads or one load a key by the words'
  alignment.
* ``radix_rank`` — one pass's stable ranks
  ``rank[i] = starts[d_i] + #{j < i : d_j == d_i}``: one sweep with
  decoupled look-back over tiles of ``RANK_TILE`` elements.
* ``radix_pass`` — the same sweep fused into an LSD pass: it reads the key
  words in their current order, finds each digit, and scatters the words
  and an int32 payload to their ranks.  Its launches count as
  ``radix_rank`` launches: it is that kernel with the scatter on.

The port of ``repro.kernels.radix_sort``; the plain versions are in
``kernels.ref`` (``ref.radix_rank_tiled`` emulates the rank sweep's tile
plan) and ``kernels.ops`` picks between them.  These wrappers take CUDA
tensors only.  Both sweeps' constants are held against the built
kernel's (:func:`kernel_config`, :func:`hist_kernel_config`) when the
library is loaded.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core.radix import HIST_BUCKETS
from ..device import record_kernel, sm_count
from . import build

_NAME = "radix_sort"
_MAX_PASS = 8
_checked = False

#: Elements of one tile of the rank sweep, threads and warps of its
#: block (a warp holds a contiguous ``RANK_TILE // RANK_WARPS`` of the
#: tile), and the predecessor status words its look-back reads at once.
RANK_TILE = 4096
RANK_THREADS = 256
RANK_WARPS = 8
LOOKBACK = 4

_CONFIG_KEYS = ("tile", "threads", "warps", "lookback")

#: Threads of a histogram block and blocks an SM of its persistent grid;
#: keys a lane reads with one 16-byte load of each word, and the key
#: vectors a lane loads before it counts any (2 words: 64 KiB in flight an
#: SM); and the copies of each bucket in shared memory (lane l adds to
#: copy l % HIST_COPIES).
HIST_THREADS = 1024
HIST_BLOCKS_PER_SM = 1
HIST_KEYS = 4
HIST_UNROLL = 2
HIST_COPIES = 1
#: Bytes of one vector load.
VEC_BYTES = 16
_HIST_PATHS = {"scalar": 0, "vector": 1}
_HIST_CONFIG_KEYS = ("threads", "blocks_per_sm", "keys", "unroll",
                     "copies", "max_pass", "registers", "local_bytes")


@dataclass(frozen=True)
class HistPlan:
    """The histogram sweep a call launches: ``path`` is ``vector`` (one
    16-byte load of each word for four keys) or ``scalar`` (one load a
    key); ``blocks`` the persistent grid, which walks ``vectors`` groups of
    ``HIST_KEYS`` keys (the last one cut by T), ``tail`` of the keys by
    scalar loads: T mod 4 on the vector path, all on the scalar path."""
    path: str
    blocks: int
    vectors: int
    tail: int


def hist_plan(n: int, aligned: bool, sms: int) -> HistPlan:
    """The sweep over ``n`` keys on a card of ``sms`` SMs; ``aligned``:
    every key word starts on a 16-byte boundary.  The grid is
    ``HIST_BLOCKS_PER_SM`` blocks an SM, or fewer when the keys do not
    give every thread of them a vector."""
    vectors = -(-n // HIST_KEYS)
    blocks = max(1, min(sms * HIST_BLOCKS_PER_SM,
                        -(-vectors // HIST_THREADS)))
    if aligned:
        return HistPlan("vector", blocks, vectors, n % HIST_KEYS)
    return HistPlan("scalar", blocks, vectors, n)


def hist_plan_for(words: Sequence[torch.Tensor]) -> HistPlan:
    """:func:`hist_plan` of a call on ``words`` (CUDA tensors)."""
    return hist_plan(words[0].shape[0],
                     all(w.data_ptr() % VEC_BYTES == 0 for w in words),
                     sm_count(words[0].device))


#: The ctypes arrays of each plan's shifts and widths, made once.
_c_digits: Dict[Tuple[Tuple[int, ...], Tuple[int, ...]],
                Tuple[ctypes.Array, ctypes.Array]] = {}


def _digits(shifts: Sequence[int], widths: Sequence[int]):
    key = (tuple(shifts), tuple(widths))
    arrays = _c_digits.get(key)
    if arrays is None:
        arrays = _c_digits[key] = ((ctypes.c_int * _MAX_PASS)(*key[0]),
                                   (ctypes.c_int * _MAX_PASS)(*key[1]))
    return arrays


def _config(lib: ctypes.CDLL) -> Dict[str, int]:
    out = (ctypes.c_int64 * len(_CONFIG_KEYS))()
    build.check(lib, _NAME, lib.radix_rank_config(ctypes.addressof(out)))
    return dict(zip(_CONFIG_KEYS, out))


def _hist_config(lib: ctypes.CDLL, vector: bool,
                 words: int) -> Dict[str, int]:
    out = (ctypes.c_int64 * len(_HIST_CONFIG_KEYS))()
    build.check(lib, _NAME, lib.radix_histogram_config(
        int(vector), words, ctypes.addressof(out)))
    return dict(zip(_HIST_CONFIG_KEYS, out))


def _lib() -> ctypes.CDLL:
    """The loaded library; on first use both sweeps' constants are held
    against this module's."""
    global _checked
    lib = build.load(_NAME)
    if not _checked:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.radix_histogram_launch.argtypes = [vp, vp, ip, ip, ci, vp, ci,
                                               ci, ci, vp]
        lib.radix_histogram_launch.restype = ci
        lib.radix_histogram_config.argtypes = [ci, ci, vp]
        lib.radix_histogram_config.restype = ci
        lib.radix_rank_launch.argtypes = [vp, vp, vp, vp, ci, vp]
        lib.radix_rank_launch.restype = ci
        lib.radix_pass_launch.argtypes = [vp, vp, ci, ci] + [vp] * 6 + [
            ci, vp]
        lib.radix_pass_launch.restype = ci
        lib.radix_rank_scratch_words.argtypes = [ci]
        lib.radix_rank_scratch_words.restype = ctypes.c_int64
        lib.radix_rank_config.argtypes = [vp]
        lib.radix_rank_config.restype = ci
        cfg = _config(lib)
        got = tuple(cfg[k] for k in _CONFIG_KEYS)
        want = (RANK_TILE, RANK_THREADS, RANK_WARPS, LOOKBACK)
        if got != want:
            raise RuntimeError(
                "radix_rank: the kernel's R_TILE, R_TPB, R_WARPS, LOOKBACK "
                f"are {got}, this module's {want}")
        hcfg = _hist_config(lib, True, 2)
        got = tuple(hcfg[k] for k in _HIST_CONFIG_KEYS[:6])
        want = (HIST_THREADS, HIST_BLOCKS_PER_SM, HIST_KEYS, HIST_UNROLL,
                HIST_COPIES, _MAX_PASS)
        if got != want:
            raise RuntimeError(
                "radix_histogram: the kernel's H_THREADS, H_BLOCKS_PER_SM, "
                "H_KEYS, H_UNROLL, H_COPIES, MAX_PASS are "
                f"{got}, this module's {want}")
        _checked = True
    return lib


def kernel_config() -> Dict[str, int]:
    """The built rank sweep's constants (``tile``, ``threads``,
    ``warps``, ``lookback``)."""
    return _config(_lib())


def hist_kernel_config(vector: bool = True, words: int = 2
                       ) -> Dict[str, int]:
    """The built histogram sweep's constants and, for the variant
    (``vector`` loads or not, 1 or 2 ``words``), its ``registers`` and
    ``local_bytes`` a thread."""
    return _hist_config(_lib(), vector, words)


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
    out = torch.empty((npass, HIST_BUCKETS), dtype=torch.int32, device=dev)
    if n == 0 or npass == 0:
        return out.zero_()
    lib = _lib()
    c_shifts, c_widths = _digits(shifts, widths)
    p = hist_plan_for(words)
    hi = words[0].data_ptr() if len(words) == 2 else None
    with build.on_device(dev):
        err = lib.radix_histogram_launch(
            hi, words[-1].data_ptr(), c_shifts, c_widths, npass,
            out.data_ptr(), n, _HIST_PATHS[p.path], p.blocks,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, _NAME, err, f"radix_histogram ({p.path} path)")
    radix_histogram.launches += 1
    return out


def _scratch(lib: ctypes.CDLL, n: int, dev: torch.device) -> torch.Tensor:
    """The rank sweep's scratch (a tile counter and 256 status words a
    tile), zeroed by the launch itself."""
    return torch.empty((lib.radix_rank_scratch_words(n),),
                       dtype=torch.int64, device=dev)


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
    scratch = _scratch(lib, n, dev)
    with build.on_device(dev):
        err = lib.radix_rank_launch(digits.data_ptr(), starts.data_ptr(),
                                    out.data_ptr(), scratch.data_ptr(), n,
                                    torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, _NAME, err, "radix_rank")
    radix_rank.launches += 1
    return out


def radix_pass(words: Sequence[torch.Tensor], perm: Optional[torch.Tensor],
               shift: int, width: int, starts: torch.Tensor
               ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """One LSD pass on the card.  words: 1-2 msb-first (T,) int32 key words
    in their current order; perm: (T,) int32 payload (None: the identity
    ``arange(T)``); the digit is bits ``[shift, shift + width)`` of the
    conceptual key (``core.radix.extract_digit``), width 1..8; starts:
    (256,) int32 exclusive bucket starts of that digit -> (the words, the
    payload), each element moved to its stable rank."""
    if len(words) not in (1, 2):
        raise ValueError(f"radix_pass: 1 or 2 words, got {len(words)}")
    if not words[0].is_cuda:
        raise ValueError("radix_pass: the CUDA kernel needs CUDA tensors, "
                         f"got {words[0].device}")
    n, dev = words[0].shape[0], words[0].device
    for j, w in enumerate(words):
        _check(w, f"words[{j}]", "radix_pass", n, dev)
    if perm is not None:
        _check(perm, "perm", "radix_pass", n, dev)
    _check(starts, "starts", "radix_pass", HIST_BUCKETS, dev)
    if not (1 <= width <= 8 and 0 <= shift
            and shift + width <= 32 * len(words)):
        raise ValueError(f"radix_pass: digit bits [{shift}, {shift + width})"
                         f" do not fit {len(words)} word(s) of 8-bit digits")
    out_words = tuple(torch.empty_like(w) for w in words)
    out_perm = torch.empty_like(words[0])
    if n == 0:
        return out_words, out_perm
    lib = _lib()
    scratch = _scratch(lib, n, dev)
    hi, hi_out = ((words[0].data_ptr(), out_words[0].data_ptr())
                  if len(words) == 2 else (None, None))
    with build.on_device(dev):
        err = lib.radix_pass_launch(
            hi, words[-1].data_ptr(), shift, width,
            None if perm is None else perm.data_ptr(), starts.data_ptr(),
            hi_out, out_words[-1].data_ptr(), out_perm.data_ptr(),
            scratch.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, _NAME, err, "radix_rank (fused pass)")
    radix_rank.launches += 1
    return out_words, out_perm


def histogram_work(n: int, words: int, passes: int) -> Tuple[int, int]:
    """(bytes, operations) of one ``radix_histogram`` call: the key words
    read once, the (passes, 256) int32 histograms written once, three
    operations (digit, increment, bounds) an element and pass."""
    return 4 * words * n + 4 * HIST_BUCKETS * passes, 3 * n * passes


def rank_work(n: int) -> Tuple[int, int]:
    """(bytes, operations) of one rank-only ``radix_rank`` call: the
    digits and starts read, the ranks written, four operations an
    element."""
    return 4 * n + 4 * HIST_BUCKETS + 4 * n, 4 * n


def pass_work(n: int, words: int, payload: bool) -> Tuple[int, int]:
    """(bytes, operations) of one fused ``radix_pass``: the key words and
    the payload (when given) read once, the moved words and payload
    written once, the starts read; eight operations an element."""
    lanes_in = words + int(payload)
    return 4 * n * (lanes_in + words + 1) + 4 * HIST_BUCKETS, 8 * n


def _rank_scratch_bytes(n: int) -> int:
    """Bytes of the rank sweep's scratch (``radix_rank_scratch_words``:
    a tile counter and 256 status words a tile, 64-bit)."""
    return 8 * (1 + -(-n // RANK_TILE) * HIST_BUCKETS)


def meta_histogram(words: Sequence[torch.Tensor], shifts: Sequence[int],
                   widths: Sequence[int]) -> torch.Tensor:
    """The dry trace's :func:`radix_histogram`: its output on ``meta``,
    one recorded call."""
    n, npass = words[0].shape[0], len(shifts)
    out = torch.empty((npass, HIST_BUCKETS), dtype=torch.int32,
                      device=words[0].device)
    if n and npass:
        record_kernel("radix_histogram",
                      *histogram_work(n, len(words), npass))
    return out


def meta_rank(digits: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The dry trace's :func:`radix_rank`: its output and scratch on
    ``meta``, one recorded call."""
    n = digits.shape[0]
    out = torch.empty_like(digits)
    if n:
        torch.empty((_rank_scratch_bytes(n),), dtype=torch.uint8,
                    device=digits.device)
        record_kernel("radix_rank", *rank_work(n))
    return out


def meta_pass(words: Sequence[torch.Tensor], perm: Optional[torch.Tensor],
              shift: int, width: int, starts: torch.Tensor):
    """The dry trace's :func:`radix_pass`: its outputs and scratch on
    ``meta``, one recorded ``radix_rank`` call."""
    n = words[0].shape[0]
    out_words = tuple(torch.empty_like(w) for w in words)
    out_perm = torch.empty_like(words[0])
    if n:
        torch.empty((_rank_scratch_bytes(n),), dtype=torch.uint8,
                    device=words[0].device)
        record_kernel("radix_rank",
                      *pass_work(n, len(words), perm is not None))
    return out_words, out_perm


#: Launches of each kernel since the last reset (``kernels.ops``);
#: ``radix_pass`` counts in ``radix_rank``'s.
radix_histogram.launches = 0
radix_rank.launches = 0
