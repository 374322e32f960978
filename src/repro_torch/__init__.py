"""PyTorch port of the triclustering system, for one NVIDIA Hopper card.

The package mirrors ``repro``'s layout (``core/keys.py``, ``core/radix.py``,
``core/pipeline.py``, ``kernels/ops.py``, ...) so that each module's
counterpart is easy to find.  It imports ``torch`` and ``numpy`` only.

Conventions:

* Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
  card that default raises (pass ``device="cpu"`` to run on the CPU).
* ``use_kernels`` (the JAX ``use_pallas``): ``None`` means "the tensor is
  on CUDA".  On CUDA tensors the hand-written kernels of
  ``kernels/csrc/`` run; on CPU tensors their plain PyTorch versions do.
* Hash lanes and packed key words are ``int32`` tensors holding uint32 bit
  patterns: add, multiply and ``cumsum(dtype=int32)`` wrap mod 2**32,
  right shifts are masked to be logical, and word comparisons are made
  unsigned explicitly (``core.keys.word_key``).
"""
from .device import on_cuda, resolve_device, resolve_use_kernels

__all__ = ["on_cuda", "resolve_device", "resolve_use_kernels"]
