"""uint32 arithmetic on ``int32`` tensors.

This PyTorch cannot shift, add or compare ``uint32``/``uint64`` tensors,
so the port holds every hash lane and packed key word as an ``int32``
bit pattern.  Add, multiply and ``cumsum(dtype=torch.int32)`` wrap
mod 2**32 exactly as uint32 arithmetic does; what differs is gathered
here:

* ``>>`` on ``int32`` is an arithmetic shift: :func:`srl` masks it into
  a logical one;
* constants >= 2**31 must be written as their signed twin (:func:`i32`);
* ``<`` is signed: :func:`word_key` maps 1-2 msb-first words onto one
  ``int64`` whose signed order is the words' unsigned order.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

#: The sign bit of a uint32 word, as its int32 bit pattern.
SIGN = -(1 << 31)


def i32(c: int) -> int:
    """The int32 value with the bit pattern of uint32 constant ``c``."""
    c = int(c) & 0xFFFFFFFF
    return c - (1 << 32) if c >= (1 << 31) else c


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by a static 0 <= s < 32."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def word_key(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """One int64 per element whose signed order is the unsigned order of
    the msb-first uint32 words: ``lo`` for one word, and
    ``(hi ^ 2**31) * 2**32 + lo`` for two (the flipped sign bit turns
    unsigned order into signed order without overflowing int64)."""
    lo = words[-1].to(torch.int64) & 0xFFFFFFFF
    if len(words) == 1:
        return lo
    return (words[0] ^ SIGN).to(torch.int64) * (1 << 32) + lo


def as_uint32(x: torch.Tensor) -> np.ndarray:
    """Host numpy ``uint32`` view of an int32 bit-pattern tensor."""
    return x.detach().cpu().numpy().view(np.uint32)


def from_uint32(a: np.ndarray, device=None) -> torch.Tensor:
    """Device int32 bit-pattern tensor of a numpy ``uint32`` array."""
    a = np.ascontiguousarray(a, np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(device)
