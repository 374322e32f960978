"""Dispatch over the port's kernels: the twin of ``repro.kernels.ops`` for
the kernels the port has.

Each op keeps the JAX op's calling convention and contract.  A CUDA
tensor goes to the hand-written kernel (``segment_reduce``,
``radix_sort``, ``flash_attention``, ``signature``,
``tricluster_density``, ``decode_attention``, ``rmsnorm``), which either
launches or raises; a
CPU tensor goes to the plain version in ``ref``.  ``use_kernels`` is
resolved by ``device.resolve_use_kernels``: ``None`` follows the tensor's
device, ``True`` on a CPU tensor raises, ``False`` runs the plain version.
There is no fallback from a kernel that fails to build or launch.  Inside
a dry trace (``analysis.ops.Trace``) a ``meta`` tensor resolves as a CUDA
one, and the op calls its kernel's meta function (its outputs on
``meta`` and one recorded call with the kernel's ``work``): the plain
version is never traced in a kernel's place.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..device import resolve_use_kernels
from . import ref
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import radix_sort as _radix
from . import rmsnorm as _rmsnorm
from . import segment_reduce as _segment
from . import signature as _signature
from . import tricluster_density as _density

#: Every kernel of the port, by name: each wrapper counts its launches in
#: ``.launches``.
KERNELS = {
    "segment_reduce": _segment.segment_reduce,
    "radix_histogram": _radix.radix_histogram,
    "radix_rank": _radix.radix_rank,
    "flash_attention": _flash.flash_attention,
    "signature": _signature.signature,
    "tricluster_density": _density.tricluster_density,
    "decode_attention": _decode.decode_attention,
    "rmsnorm": _rmsnorm.rmsnorm,
}

#: The kernels each path of the port launches: ``mining`` is a
#: ``BatchMiner``/``NOACMiner`` call, ``routing`` the MoE routing pass
#: (``models.telemetry.collect_moe_routing``) that feeds it, ``dense`` the
#: dense validation path (``core.batch.fibers`` masks hashed by
#: :func:`set_signature`, and ``core.batch.exact_density_dense``),
#: ``serving`` LM prefill and ring-cache decode (``serve.engine``) with
#: ``attn_impl="pallas"`` and ``use_pallas=True``.
PATH_KERNELS = {
    "mining": ("segment_reduce", "radix_histogram", "radix_rank"),
    "routing": ("flash_attention",),
    "dense": ("signature", "tricluster_density"),
    "serving": ("decode_attention", "rmsnorm"),
}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def segment_reduce(w_lo: torch.Tensor, w_hi: torch.Tensor,
                   first: torch.Tensor, *,
                   use_kernels: Optional[bool] = None):
    """Fused masked prefix sums for Stage-2 segment reductions.

    w_lo/w_hi (T,) int32 hash weights (uint32 bit patterns), first (T,)
    bool/0-1 mask -> three (T,) int32 inclusive prefix sums of the masked
    weights (mod 2³²) and of the mask; per-segment (or δ-window) sums are
    then boundary differences of the prefixes."""
    if resolve_use_kernels(use_kernels, w_lo):
        if w_lo.is_meta:
            return tuple(x[1:] for x in _segment.meta_exclusive(
                w_lo, w_hi, first))
        return _segment.segment_reduce(w_lo, w_hi, first)
    return ref.segment_reduce_ref(w_lo, w_hi, first)


def segment_reduce_exclusive(w_lo: torch.Tensor, w_hi: torch.Tensor,
                             first: torch.Tensor, *,
                             use_kernels: Optional[bool] = None):
    """:func:`segment_reduce` in the exclusive layout: three (T + 1,)
    int32 prefix sums, element 0 zero and element i the sum of the first
    i masked weights (and flags).  The kernel writes this layout itself;
    the plain version puts a zero before the inclusive sums."""
    if resolve_use_kernels(use_kernels, w_lo):
        if w_lo.is_meta:
            return _segment.meta_exclusive(w_lo, w_hi, first)
        return _segment.segment_reduce_exclusive(w_lo, w_hi, first)
    z = torch.zeros((1,), dtype=torch.int32, device=w_lo.device)
    return tuple(torch.cat([z, x])
                 for x in ref.segment_reduce_ref(w_lo, w_hi, first))


def radix_histogram(words: Sequence[torch.Tensor], shifts: Sequence[int],
                    widths: Sequence[int], *,
                    use_kernels: Optional[bool] = None) -> torch.Tensor:
    """One-sweep histograms of every pruned radix digit position.

    words: 1-2 msb-first (T,) int32 packed key words; shifts/widths:
    per-pass digit bit ranges -> (npass, 256) int32, exact for the T
    elements (the kernel masks its ragged tail, so no pad count has to be
    taken back out of bucket 0)."""
    if resolve_use_kernels(use_kernels, words[0]):
        if words[0].is_meta:
            return _radix.meta_histogram(words, shifts, widths)
        return _radix.radix_histogram(words, shifts, widths)
    return ref.radix_histogram_ref(words, shifts, widths)


def radix_rank(digits: torch.Tensor, starts: torch.Tensor, *,
               use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Stable radix-pass ranks ``starts[d_i] + occurrence_i``.

    digits (T,) int32 in [0, 256), starts (256,) int32 exclusive bucket
    starts -> (T,) int32."""
    if resolve_use_kernels(use_kernels, digits):
        if digits.is_meta:
            return _radix.meta_rank(digits, starts)
        return _radix.radix_rank(digits, starts)
    return ref.radix_rank_ref(digits, starts)


def radix_pass(words: Sequence[torch.Tensor], perm: Optional[torch.Tensor],
               shift: int, width: int, starts: torch.Tensor, *,
               use_kernels: Optional[bool] = None):
    """One fused LSD pass: the stable ranks of digit bits ``[shift, shift
    + width)`` of the words, and the words and the int32 payload ``perm``
    (None: ``arange(T)``) moved to them.

    words: 1-2 msb-first (T,) int32 words in their current order; starts
    (256,) int32 -> (words, payload) in the pass's order.  The kernel
    counts as a ``radix_rank`` launch."""
    if resolve_use_kernels(use_kernels, words[0]):
        if words[0].is_meta:
            return _radix.meta_pass(words, perm, shift, width, starts)
        return _radix.radix_pass([w.contiguous() for w in words], perm,
                                 shift, width, starts.contiguous())
    return ref.radix_pass_ref(words, perm, shift, width, starts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: Optional[int] = None,
                    scale: Optional[float] = None,
                    use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Batched GQA attention. q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) ->
    (B, Hq, Sq, D) in q's dtype.  ``q_offset`` is the key position of q
    row 0 (default Skv - Sq); ``window`` keeps keys with
    ``kpos > qpos - window``.  The kernel takes fp32 or bf16 and any head
    dim (zero-padded to ``kernels.flash_attention.padded_dim``'s)."""
    if resolve_use_kernels(use_kernels, q):
        if q.is_meta:
            return _flash.meta(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)
        return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      window=window, q_offset=q_offset,
                                      scale=scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: Optional[int] = None,
                     kv_len: Optional[int] = None,
                     scale: Optional[float] = None,
                     return_lse: bool = False,
                     use_kernels: Optional[bool] = None):
    """Single-token decode. q (B, Hq, D); k, v (B, Hkv, S, D) -> (B, Hq,
    D) in q's dtype.  The query sits at position ``kv_len - 1`` (default
    S - 1) and attends to keys ``[max(0, kv_len - window), kv_len)``.  k
    and v may be strided views (the kernel reads them where they lie);
    the kernel takes fp32 or bf16, any head dim (zero-padded to the next
    multiple of 8) and any GQA group.  ``return_lse``: (o, the fp32
    log-sum-exp (B, Hq) of the scaled scores), and ``kv_len`` may be 0
    (o = 0, lse = -inf)."""
    if resolve_use_kernels(use_kernels, q):
        if q.is_meta:
            return _decode.meta(q, k, v, window=window, kv_len=kv_len,
                                scale=scale, return_lse=return_lse)
        return _decode.decode_attention(q.contiguous(), k, v, window=window,
                                        kv_len=kv_len, scale=scale,
                                        return_lse=return_lse)
    return ref.decode_attention_ref(q, k, v, window=window, kv_len=kv_len,
                                    scale=scale, return_lse=return_lse)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
            use_kernels: Optional[bool] = None) -> torch.Tensor:
    """RMSNorm over the last axis with fp32 statistics, in x's dtype; any
    leading shape (folded into the kernel's rows, none padded)."""
    if resolve_use_kernels(use_kernels, x):
        d = x.shape[-1]
        norm = _rmsnorm.meta if x.is_meta else _rmsnorm.rmsnorm
        out = norm(x.reshape(-1, d).contiguous(), w.contiguous(), eps)
        return out.reshape(x.shape)
    return ref.rmsnorm_ref(x, w, eps)


def _as_bytes(a: torch.Tensor) -> torch.Tensor:
    """A 0/1 tensor as the kernels read it: bool or uint8 as it is
    (contiguous), any other dtype as ``a != 0`` (inputs are 0/1)."""
    if a.dtype not in (torch.bool, torch.uint8):
        a = a != 0
    return a.contiguous()


def set_signature(mask: torch.Tensor, r: torch.Tensor, *,
                  use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Order-independent set signatures: (T, E) 0/1 × (E,) uint32 ->
    (T,) uint32, as int32 bit patterns.  ``mask`` holds 0/1 (bool, uint8,
    int32 or float32; the kernel reads bool/uint8 bytes and other dtypes
    are converted first); any T and E, ragged edges masked in the kernel."""
    if resolve_use_kernels(use_kernels, mask):
        sig = _signature.meta if mask.is_meta else _signature.signature
        return sig(_as_bytes(mask), r.to(torch.int32).contiguous())
    return ref.signature_ref(mask, r)


def tricluster_density(tensor: torch.Tensor, x: torch.Tensor,
                       y: torch.Tensor, z: torch.Tensor, *,
                       use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Exact box-count numerators |X×Y×Z ∩ I| for T triclusters.

    tensor (G, M, B) 0/1; x (T, G); y (T, M); z (T, B) -> (T,) float32,
    exact for counts below 2**24.  The exact-density estimator (beyond the
    paper: its Alg. 7 uses the generating-tuple count approximation)."""
    if resolve_use_kernels(use_kernels, tensor):
        dens = (_density.meta if tensor.is_meta
                else _density.tricluster_density)
        return dens(_as_bytes(tensor), _as_bytes(x), _as_bytes(y),
                    _as_bytes(z))
    return ref.tricluster_density_ref(tensor, x, y, z)


def exact_density(tensor: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  z: torch.Tensor, *,
                  use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Exact densities: numerator / volume (0 if any component empty)."""
    num = tricluster_density(tensor, x, y, z, use_kernels=use_kernels)
    vol = ref.row_counts(x) * ref.row_counts(y) * ref.row_counts(z)
    return num / torch.clamp(vol, min=1.0)
