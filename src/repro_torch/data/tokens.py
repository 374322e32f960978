"""Deterministic, resumable LM token pipeline.  A numpy copy of
``repro.data.tokens``, kept here so that the port imports nothing of the
JAX package; the parity tests hold the two batch for batch.

Every batch is a pure function of ``(seed, step)`` — the training state
only needs to carry ``data_step`` (an int) to resume bit-identically after
a crash/restart on any worker count. The synthetic "language" is Zipf
unigrams with injected repeated motifs so a real model's loss actually
decreases (quickstart/train examples assert this).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step,)))


@dataclasses.dataclass
class TokenPipeline:
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    motif_len: int = 8
    motif_count: int = 64
    motif_rate: float = 0.5      # fraction of positions covered by motifs

    def __post_init__(self):
        rng = _rng(self.seed, 0)
        v = max(self.cfg.vocab_size - 1, 2)
        self.motifs = rng.integers(
            1, v, size=(self.motif_count, self.motif_len)).astype(np.int32)

    def _tokens(self, step: int) -> np.ndarray:
        rng = _rng(self.seed, step + 1)
        b, s = self.global_batch, self.seq_len
        v = max(self.cfg.vocab_size - 1, 2)
        # Zipf-ish unigram background
        u = rng.random((b, s))
        toks = np.minimum((u ** 3 * v).astype(np.int32) + 1, v)
        # paste motifs over ~motif_rate of the stream
        n_paste = int(b * s * self.motif_rate / self.motif_len)
        rows = rng.integers(0, b, n_paste)
        cols = rng.integers(0, max(s - self.motif_len, 1), n_paste)
        ids = rng.integers(0, self.motif_count, n_paste)
        for r, c, i in zip(rows, cols, ids):
            toks[r, c:c + self.motif_len] = self.motifs[i]
        return toks

    def batch_at(self, step: int) -> dict:
        """Training batch for one step: tokens + next-token labels."""
        toks = self._tokens(step)
        labels = np.concatenate(
            [toks[:, 1:], np.full((self.global_batch, 1), -100, np.int32)],
            axis=1)
        out = {"tokens": toks, "labels": labels}
        if self.cfg.frontend == "patch":
            rng = _rng(self.seed ^ 0xBEEF, step + 1)
            out["patches"] = rng.standard_normal(
                (self.global_batch, self.cfg.frontend_len,
                 self.cfg.frontend_dim)).astype(np.float32)
        if self.cfg.family == "encdec":
            rng = _rng(self.seed ^ 0xF00D, step + 1)
            out["frames"] = rng.standard_normal(
                (self.global_batch, self.seq_len,
                 self.cfg.frontend_dim)).astype(np.float32)
        return out

    def prompts(self, n: int, length: int, step: int = 0) -> list:
        """Synthetic prompts for serving runs (ragged lengths)."""
        rng = _rng(self.seed ^ 0xCAFE, step + 1)
        v = max(self.cfg.vocab_size - 1, 2)
        return [rng.integers(1, v, size=max(1, length - (i % 3))).tolist()
                for i in range(n)]
