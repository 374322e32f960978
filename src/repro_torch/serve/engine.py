"""Batched serving engine (prefill + ragged decode).  Port of
``repro.serve.engine``.

Ragged prompt batching without masks or cache surgery: prefill runs on the
*common prefix* (min prompt length), then the decode loop *replays* each
sequence's remaining prompt tokens by teacher forcing — ``decode_step``
takes a (B,) token vector, so every step each slot independently feeds
either its next prompt token (still inside its prompt) or its previously
sampled token (generating).  Correct for causal LMs with per-sequence
positions identical, which holds because every slot advances one position
per step.

Greedy decoding (``temperature=0``) takes the ``argmax`` of the logits.
Temperature sampling draws from ``torch.multinomial`` with a
``torch.Generator`` on the engine's device, seeded from ``seed``: the
same seed gives the same tokens on the same device, but not the JAX
engine's ``jax.random`` draws.  The engine reads the next tokens back to
the host once per step (the replay logic runs there), which is also where
``decode_step`` reads the cache position.

The enc-dec family is refused: its prefill takes frames, which the
engine (the JAX package's too) does not pass.

Over a device mesh (``rules``, a ``sharding.MeshRules``) every rank of
the mesh runs the same engine on its blocks of ``params``
(``Model.init(rules=...)``) and the same prompts: prefill and decode
return the global logits on every rank, so every rank picks the same
tokens (greedy, or from the same seeded generator).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.api import get_model


@dataclasses.dataclass
class GenerationResult:
    tokens: list                  # list[list[int]] generated per request
    prefill_s: float
    decode_s: float
    steps: int

    @property
    def tokens_per_s(self) -> float:
        n = sum(len(t) for t in self.tokens)
        return n / self.decode_s if self.decode_s else float("inf")


class ServeEngine:
    """Serves ``cfg`` with ``params`` on the parameters' device; over a
    mesh (``rules``) ``params`` are this rank's blocks."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 2048,
                 rules=None, temperature: float = 0.0,
                 eos_id: Optional[int] = None, seed: int = 0):
        if cfg.family == "encdec":
            raise ValueError(
                f"{cfg.name}: the enc-dec family serves through "
                "Model.prefill / decode_step with frames ({'frames', "
                "'tokens'}); ServeEngine passes tokens only, as the JAX "
                "package's does")
        self.cfg, self.params, self.rules = cfg, params, rules
        self.max_len = max_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.model = get_model(cfg)
        self.device = params["embed"].device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _next(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V) logits -> (B,) next tokens on the device."""
        if self.temperature > 0:
            probs = torch.softmax(logits.to(torch.float32)
                                  / max(self.temperature, 1e-6), dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    # -- batched generation ---------------------------------------------------

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32) -> GenerationResult:
        b = len(prompts)
        lens = np.array([len(p) for p in prompts])
        if (lens <= 0).any():
            raise ValueError("empty prompt")
        s_min = int(lens.min())
        s_max = int(lens.max())
        total = s_max + max_new_tokens
        if total > self.max_len and self.cfg.window is None:
            raise ValueError(f"total {total} exceeds engine max_len "
                             f"{self.max_len}")
        # right-pad prompts; padding is only read by the replay logic below
        pad = np.zeros((b, s_max), np.int64)
        for i, p in enumerate(prompts):
            pad[i, :len(p)] = p

        t0 = time.perf_counter()
        cache, logits = self.model.prefill(
            self.cfg, self.params, {"tokens": pad[:, :s_min]}, self.max_len,
            self.rules)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prefill_s = time.perf_counter() - t0

        # per-slot cursor: absolute position of the next token to *feed*
        cursor = np.full((b,), s_min)
        last = torch.argmax(logits, dim=-1).cpu().numpy()  # next-token guess
        done = np.zeros((b,), bool)
        out: list[list[int]] = [[] for _ in range(b)]

        t0 = time.perf_counter()
        steps = 0
        while True:
            replaying = cursor < lens
            full = np.array([len(o) >= max_new_tokens for o in out])
            if (~replaying & (done | full)).all():
                break
            feed = np.where(replaying, pad[np.arange(b),
                                           np.minimum(cursor, s_max - 1)],
                            last)
            cache, logits = self.model.decode_step(self.cfg, self.params,
                                                   cache, feed, self.rules)
            nxt = self._next(logits).cpu().numpy()
            steps += 1
            for i in range(b):
                if replaying[i]:
                    pass                       # still consuming the prompt
                elif not done[i] and len(out[i]) < max_new_tokens:
                    out[i].append(int(last[i]))
                    if self.eos_id is not None and last[i] == self.eos_id:
                        done[i] = True
            last = nxt
            cursor += 1
            if steps > self.max_len + max_new_tokens:
                raise RuntimeError("decode loop failed to terminate")
        decode_s = time.perf_counter() - t0
        return GenerationResult(out, prefill_s, decode_s, steps)
