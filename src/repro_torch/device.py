"""Device rules of the port: where an entry point runs, and whether a
kernel op launches its CUDA kernel or runs its plain PyTorch version.

The twin of ``repro.kernels.ops.on_tpu``/``_interpret``.  Nothing here
falls back silently: the default device is CUDA and asking for it
without a card raises, naming ``device="cpu"``.

Inside a dry trace (``analysis.ops.Trace``, the active :func:`dry_trace`)
a tensor on the ``meta`` device stands for one on the card: kernel ops
resolve as they would there and call their kernel's meta function, which
records the call (:func:`record_kernel`) instead of launching, and a dry
mesh's collectives record themselves with the trace too
(``core.collectives``)."""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

#: Default device of every entry point.
DEFAULT_DEVICE = "cuda"

_sm_counts: Dict[int, int] = {}

#: The active dry trace (an object with ``kernel(name, bytes,
#: operations, tensor)`` and ``collective(kind, operand bytes, result
#: bytes, group size)``); ``None`` outside one.
_dry_trace = None


def set_dry_trace(trace):
    """Make ``trace`` the active dry trace (``None``: none); returns the
    one it replaces."""
    global _dry_trace
    prev, _dry_trace = _dry_trace, trace
    return prev


def dry_trace():
    """The active dry trace, or ``None``."""
    return _dry_trace


def record_kernel(name: str, nbytes: int, ops: int,
                  tensor: bool = False) -> None:
    """Record one call of kernel ``name`` that would move ``nbytes`` and
    do ``ops`` operations (on the tensor cores when ``tensor``)."""
    if _dry_trace is None:
        raise RuntimeError(f"{name}: a kernel's meta function runs only "
                           "inside a dry trace (analysis.ops.Trace)")
    _dry_trace.kernel(name, int(nbytes), int(ops), bool(tensor))


def on_card(x: torch.Tensor) -> bool:
    """True when ``x`` lies on the card, or stands for a tensor there
    (``meta`` inside a dry trace)."""
    return x.is_cuda or (x.is_meta and _dry_trace is not None)


def on_cuda() -> bool:
    """True when a CUDA card is visible to this process."""
    return torch.cuda.is_available()


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` or the CUDA default.
    Raises when CUDA is asked for and no card is visible."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device=\"cpu\" to run on the CPU")
    return dev


def resolve_use_kernels(use_kernels: Optional[bool],
                        x: torch.Tensor) -> bool:
    """Whether an op on tensor ``x`` launches its CUDA kernel.

    ``None``: exactly when ``x`` lies on CUDA (or on ``meta`` inside a
    dry trace: :func:`on_card`).  ``True`` on a CPU tensor raises (there
    is no kernel for the CPU); ``False`` runs the plain PyTorch version
    wherever ``x`` lies."""
    if use_kernels is None:
        return on_card(x)
    if use_kernels and not on_card(x):
        raise ValueError(
            f"use_kernels=True needs CUDA tensors, got a tensor on "
            f"{x.device}; leave use_kernels=None to run the plain version "
            "on the CPU")
    return bool(use_kernels)


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``'s card, read once."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]
