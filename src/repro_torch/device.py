"""Device rules of the port: where an entry point runs, and whether a
kernel op launches its CUDA kernel or runs its plain PyTorch version.

The twin of ``repro.kernels.ops.on_tpu``/``_interpret``.  Nothing here
falls back silently: the default device is CUDA and asking for it
without a card raises, naming ``device="cpu"``."""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

#: Default device of every entry point.
DEFAULT_DEVICE = "cuda"

_sm_counts: Dict[int, int] = {}


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

    ``None``: exactly when ``x`` lies on CUDA.  ``True`` on a CPU tensor
    raises (there is no kernel for the CPU); ``False`` runs the plain
    PyTorch version wherever ``x`` lies."""
    if use_kernels is None:
        return x.is_cuda
    if use_kernels and not x.is_cuda:
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
