"""Wrapper of the CUDA kernel ``csrc/decode_attention.cu``: single-token
GQA decode attention over a KV cache, forward only.

    q (B, Hq, D), k and v (B, Hkv, S, D) -> o (B, Hq, D)

The query sits at position ``kv_len - 1``: it attends to the keys
``[max(0, kv_len - window), kv_len)``.  The port of
``repro.kernels.decode_attention``; the plain version is
``kernels.ref.decode_attention_ref`` and ``kernels.ops.decode_attention``
picks between them.  This wrapper takes CUDA tensors in fp32 or bf16: a
contiguous q, and k and v with the same strides and a unit stride on D,
read where they lie (a permuted view of a (B, S, Hkv, D) ring cache needs
no copy).  Head dims: those of the flash kernel, and 80.  There is no
backward kernel, so it refuses inputs that require a gradient.

The kernel splits the key range (flash-decoding): :func:`split_plan`
cuts ``[lo, kv_len)`` into ranges of whole 64-key tiles so that the
(B·Hkv, n_split) grid holds about two blocks per SM, and a second, small
CUDA kernel combines the splits' partial softmax states from an fp32
scratch that the wrapper allocates.  One call is one launch in
``decode_attention.launches``, whether it runs one CUDA kernel
(``n_split = 1``) or two.

``return_lse=True`` also gives the fp32 log-sum-exp of the scaled scores
over the keys, (B, Hq), which the kernel writes beside O (``m + log l``
of its softmax state, combined over the splits): what ranks that each
hold a block of a ring's slots need to combine their outputs.  A
``kv_len`` of 0 (a block with no filled slot) is answered without a
launch: o = 0, lse = -inf.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..device import sm_count
from . import build
from .flash_attention import HEAD_DIMS as _FLASH_HEAD_DIMS

_NAME = "decode_attention"
#: Head dims the wrapper takes.
HEAD_DIMS = tuple(sorted(_FLASH_HEAD_DIMS + (80,)))
#: Shared memory a block may use on Hopper.
MAX_SMEM_BYTES = 232_448
#: Keys per tile of the kernel; a split takes whole tiles.
KEY_TILE = 64
#: Blocks per SM that the split count aims the grid at.
BLOCKS_PER_SM = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_argtypes_set = False


def split_plan(kv_len: int, window: Optional[int], kv_blocks: int,
               sm_count: int) -> Tuple[int, int, int]:
    """(first tile, tiles per split, number of splits) for a query at
    ``kv_len - 1`` over ``kv_blocks = B·Hkv`` (batch, kv head) blocks on a
    card of ``sm_count`` SMs.

    The keys ``[lo, kv_len)`` (``lo = max(0, kv_len - window)``) lie in the
    tiles ``lo // 64 .. (kv_len - 1) // 64``.  The grid aims at
    ``BLOCKS_PER_SM · sm_count`` blocks: one split when ``kv_blocks`` fills
    that alone, else the tiles are dealt in equal runs to about
    ``ceil(target / kv_blocks)`` splits, the last run possibly shorter and
    none empty."""
    lo = 0 if window is None else max(0, kv_len - window)
    t_first, t_last = lo // KEY_TILE, (kv_len - 1) // KEY_TILE
    n_tiles = t_last - t_first + 1
    target = BLOCKS_PER_SM * sm_count
    if kv_blocks >= target:
        return t_first, n_tiles, 1
    want = min(-(-target // kv_blocks), n_tiles)
    per = -(-n_tiles // want)
    return t_first, per, -(-n_tiles // per)


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = build.load(_NAME)
    if not _argtypes_set:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.decode_attention_launch.argtypes = (
            [vp] * 6 + [ci] * 5 + [ll] * 3 + [ci] * 3 + [ctypes.c_float]
            + [ci] * 5 + [vp])
        lib.decode_attention_launch.restype = ci
        lib.decode_attention_smem_bytes.argtypes = [ci, ci, ci]
        lib.decode_attention_smem_bytes.restype = ll
        _argtypes_set = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_len: int, window: Optional[int], lse: bool = False) -> None:
    if any(x.requires_grad for x in (q, k, v)):
        raise ValueError("decode_attention: there is no backward kernel; "
                         "call it on tensors that do not require a gradient "
                         "(for example under torch.no_grad())")
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported "
                         "(float32 or bfloat16)")
    for x, what in ((k, "k"), (v, "v")):
        if x.dtype != q.dtype:
            raise ValueError(f"decode_attention: {what} must be {q.dtype}, "
                             f"got {x.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q (B,Hq,D) and k, v "
                         f"(B,Hkv,S,D) expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch or head dim")
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"decode_attention: Hq={hq} is not a multiple of "
                         f"Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not supported "
                         f"(one of {HEAD_DIMS})")
    if not (0 if lse else 1) <= kv_len <= s:
        raise ValueError(f"decode_attention: kv_len={kv_len} outside "
                         f"[{0 if lse else 1}, S={s}] (0 only with "
                         "return_lse)")
    if window is not None and window < 1:
        raise ValueError(f"decode_attention: window={window} must be >= 1")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    if k.stride() != v.stride() or k.stride(3) != 1:
        raise ValueError(f"decode_attention: k and v need the same strides "
                         f"and a unit stride on D, got {k.stride()} and "
                         f"{v.stride()}")
    if not q.is_cuda:
        raise ValueError("decode_attention: the CUDA kernel needs CUDA "
                         f"tensors, got {q.device}")
    for x, what in ((k, "k"), (v, "v")):
        if x.device != q.device:
            raise ValueError(f"decode_attention: {what} must lie on "
                             f"{q.device}, got {x.device}")


def _vec16(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel may read K and V rows as 16-byte vectors."""
    es = k.element_size()
    return (all(p % 16 == 0 for p in (k.data_ptr(), v.data_ptr()))
            and all(st * es % 16 == 0 for st in k.stride()[:3])
            and k.shape[3] * es % 16 == 0)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: Optional[int] = None,
                     kv_len: Optional[int] = None,
                     scale: Optional[float] = None,
                     return_lse: bool = False):
    """Decode attention computed on the card; ``kv_len`` defaults to S and
    ``scale`` to D**-0.5.  ``return_lse``: (o, lse (B, Hq) fp32)."""
    if kv_len is None:
        kv_len = k.shape[2] if k.dim() == 4 else 0
    _check(q, k, v, kv_len, window, return_lse)
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    lib = _lib()
    smem = lib.decode_attention_smem_bytes(hq // hkv, d, _DTYPES[q.dtype])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"decode_attention: GQA group {hq // hkv} x head "
                         f"dim {d} needs {smem} bytes of shared memory, "
                         f"more than {MAX_SMEM_BYTES}")
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if kv_len == 0:              # no key: nothing to launch
        out.zero_()
        lse.fill_(float("-inf"))
        return out, lse
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    sb, sh, ss, _ = k.stride()
    t_first, per, n_split = split_plan(int(kv_len), window, b * hkv,
                                       sm_count(q.device))
    # the splits' partial (acc, m, l), combined by the second kernel
    part = (torch.empty((b, hq, n_split, d + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if part is None else part.data_ptr(), b, hq, hkv, s, d, sb,
            sh, ss, int(kv_len), int(window is not None), int(window or 0),
            float(scale), _DTYPES[q.dtype], int(_vec16(k, v)), t_first, per,
            n_split, stream)
    build.check(lib, _NAME, err)
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


#: Launches of the kernel since the last reset (``kernels.ops``).
decode_attention.launches = 0
