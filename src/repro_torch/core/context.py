"""Polyadic formal contexts: the input data structure of the paper.

A numpy-only copy of ``repro.core.context``, kept here so that the port
imports nothing of the JAX package; the two must stay identical in
behaviour (the parity tests build contexts with both).

A polyadic context K_N = (A_1, ..., A_N, I ⊆ A_1 × ... × A_N) is stored as

  * ``sizes``  — tuple (n_1, ..., n_N) of mode cardinalities,
  * ``tuples`` — int32 array of shape (T, N), one row per element of I,
  * optional ``values`` — float32 array (T,) for many-valued contexts
    (the valuation function V of §3.2 of the paper),
  * optional ``names`` — per-mode list of entity names (host-side only;
    everything on device is integer ids, see DESIGN.md §3).

Duplicated rows are legal (M/R at-least-once semantics, paper §5.1: the
algebra must be idempotent under duplicates) — except in many-valued
contexts, where V must be a *function* of the tuple (§3.2).  Duplicate
rows of a valued context are therefore canonicalised at construction:
one row per distinct tuple, the **last** value winning (the upsert
semantics of the paper's online Algorithm 1).  Without this, duplicate
rows carrying conflicting values make every NOAC engine's output
depend on which copy it happens to see first — the historical
seq-vs-par MISMATCH of ``benchmarks/table5.py``.  (The streaming
engine ingests raw arrays, bypassing this constructor, but applies the
*same* last-write-wins rule through the run store's tombstones — a
valued ``add`` is an upsert; see ``core/runs.py``.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PolyadicContext:
    sizes: tuple[int, ...]
    tuples: np.ndarray  # (T, N) int32
    values: Optional[np.ndarray] = None  # (T,) float32, many-valued contexts
    names: Optional[tuple[list, ...]] = None  # host-side entity labels

    def __post_init__(self):
        t = np.asarray(self.tuples, dtype=np.int32)
        object.__setattr__(self, "tuples", t)
        if t.ndim != 2 or t.shape[1] != len(self.sizes):
            raise ValueError(
                f"tuples shape {t.shape} incompatible with sizes {self.sizes}")
        if t.size and (t.min() < 0 or (t.max(axis=0) >= np.asarray(self.sizes)).any()):
            raise ValueError("entity id out of range")
        if self.values is not None:
            v = np.asarray(self.values, dtype=np.float32)
            if v.shape != (t.shape[0],):
                raise ValueError("values must be (T,)")
            object.__setattr__(self, "values", v)
            if t.shape[0]:
                # canonicalise: V is a function of the tuple (§3.2) —
                # keep one row per distinct tuple in first-occurrence
                # order, last value winning (upsert semantics).  Row
                # order is preserved so duplicate-free workloads — and
                # the sort benchmarks — see the input exactly as given.
                uniq, first, inv = np.unique(t, axis=0, return_index=True,
                                             return_inverse=True)
                if uniq.shape[0] != t.shape[0]:
                    inv = inv.ravel()
                    last = np.empty(uniq.shape[0], np.intp)
                    last[inv] = np.arange(t.shape[0])
                    order = np.argsort(first, kind="stable")
                    object.__setattr__(self, "tuples", uniq[order])
                    object.__setattr__(self, "values", v[last][order])

    @property
    def arity(self) -> int:
        return len(self.sizes)

    @property
    def num_tuples(self) -> int:
        return int(self.tuples.shape[0])

    @property
    def volume(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def density(self) -> float:
        uniq = np.unique(self.tuples, axis=0)
        return len(uniq) / self.volume

    def dense(self) -> np.ndarray:
        """Dense boolean incidence tensor (use only for small contexts)."""
        out = np.zeros(self.sizes, dtype=bool)
        out[tuple(self.tuples.T)] = True
        return out

    def deduplicated(self) -> "PolyadicContext":
        """Distinct-row view.  Valued contexts are already canonicalised
        at construction (one row per tuple, last value wins — the only
        dedup policy), so they return themselves unchanged."""
        if self.values is not None:
            return self
        uniq = np.unique(self.tuples, axis=0)
        if uniq.shape[0] == self.tuples.shape[0]:
            return self
        return PolyadicContext(self.sizes, uniq, None, self.names)

    def subsample(self, n: int, seed: int = 0) -> "PolyadicContext":
        rng = np.random.default_rng(seed)
        idx = rng.choice(self.num_tuples, size=min(n, self.num_tuples),
                         replace=False)
        vals = self.values[idx] if self.values is not None else None
        return PolyadicContext(self.sizes, self.tuples[idx], vals, self.names)


def tricontext(sizes: Sequence[int], triples, values=None,
               names=None) -> PolyadicContext:
    """Triadic convenience constructor K = (G, M, B, I)."""
    if len(sizes) != 3:
        raise ValueError("tricontext needs exactly three modes")
    return PolyadicContext(tuple(int(s) for s in sizes),
                           np.asarray(triples, np.int32), values, names)


def from_named_triples(triples: Sequence[tuple]) -> PolyadicContext:
    """Build a context from (name, name, ..., name) tuples, like the paper's
    tab-separated IMDB input (§5.1 'Input data example')."""
    if not triples:
        raise ValueError("empty input")
    arity = len(triples[0])
    vocabs: list[dict] = [dict() for _ in range(arity)]
    rows = np.empty((len(triples), arity), dtype=np.int32)
    for r, tup in enumerate(triples):
        for k, name in enumerate(tup):
            vocab = vocabs[k]
            if name not in vocab:
                vocab[name] = len(vocab)
            rows[r, k] = vocab[name]
    names = tuple([list(v.keys()) for v in vocabs])
    sizes = tuple(len(v) for v in vocabs)
    return PolyadicContext(sizes, rows, names=names)
