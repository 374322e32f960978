"""Frozen context generators: a triadic context with distinct rows, drawn
from a configuration's file and a seed.

Each mode's entities are drawn from a power law ``p_i ∝ (i + 1)^-a``
(the exponents of the configuration's ``exponents``), and rows are drawn
from the product of the marginals **without replacement**: a repeated
row is redrawn, so the table has exactly ``n_tuples`` distinct rows, as
the published datasets do.  Two exact methods draw the same law:

* sequential redraws (``_draw_rejecting``) where the product space is
  sparse, as BibSonomy's 4.6e12 cells are;
* an exponential race over every cell (``_draw_racing``) where it is
  small enough to hold, as MovieLens's 23.9 million (user, movie) pairs
  are.  Only the race can honour ``min_per_mode0`` (each entity of mode
  0 gets at least that many rows: each of its cells races within its
  row first).

A configuration with ``value_counts`` draws only the modes listed in
``distinct_modes`` and deals value ids out of a fixed multiset
(``value_counts[v]`` rows get id ``v``) in a seeded random order; the
row's float value is that id plus ``value_offset`` (MovieLens: the
star).  Where ``distinct_modes`` leaves out the last mode, the ids are
that mode's column too (the star as a mode); where it names every mode,
the value is the row's only other field (a (user, movie) context valued
by the star).  One seed deals the same rows and values either way.

Rows come in draw order.  The same (configuration, seed, index) gives
the same context; the program receives only these host arrays.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

#: Largest product space the race holds in memory (float32 keys).
RACE_CELLS = 1 << 27


def rng_for(seed: int, index: int) -> np.random.Generator:
    """The generator of context ``index`` of a run with ``seed`` (any
    whole number; negative ones wrap mod 2**64)."""
    return np.random.default_rng([int(seed) % (1 << 64), int(index)])


def power_law(n: int, exponent: float) -> np.ndarray:
    """Probabilities ``∝ (i + 1)^-exponent`` of ids 0..n-1."""
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** exponent
    return p / p.sum()


def _inverse_cdf(rng: np.random.Generator, p: np.ndarray,
                 count: int) -> np.ndarray:
    cdf = np.cumsum(p)
    cdf[-1] = 1.0
    return np.searchsorted(cdf, rng.random(count), side="right")


def _draw_rejecting(rng, sizes, probs, count: int) -> np.ndarray:
    """``count`` distinct flat cell ids, drawn one after another from the
    product law, a repeated cell redrawn: the first ``count`` distinct
    cells of a stream of draws, in draw order."""
    stream = np.empty(0, np.int64)
    while True:
        m = 2 * count
        cells = np.zeros(m, np.int64)
        for n, p in zip(sizes, probs):
            cells = cells * n + _inverse_cdf(rng, p, m)
        stream = np.concatenate([stream, cells])
        _, first = np.unique(stream, return_index=True)
        if first.size >= count:
            return stream[np.sort(first)[:count]]


def _draw_racing(rng, sizes, probs, count: int,
                 min_per_mode0: int) -> np.ndarray:
    """``count`` distinct flat cell ids by an exponential race (the
    ``count`` smallest of ``Exp(1) / p_cell``: sampling without
    replacement from the product law), each mode-0 entity first taking
    its ``min_per_mode0`` smallest cells; in race order."""
    weight = probs[0].astype(np.float32)
    for p in probs[1:]:
        weight = np.multiply.outer(weight, p.astype(np.float32))
    key = rng.standard_exponential(weight.size, dtype=np.float32)
    key /= weight.reshape(-1)
    if min_per_mode0:
        rows = key.reshape(sizes[0], -1)
        own = np.argpartition(rows, min_per_mode0 - 1, axis=1)[
            :, :min_per_mode0]
        np.put_along_axis(rows, own, -np.take_along_axis(rows, own, 1), 1)
    cells = np.argpartition(key, count - 1)[:count]
    return cells[np.argsort(key[cells], kind="stable")]


def make_context(cfg: dict, seed: int, index: int
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(tuples (T, N) int32, values (T,) float32 or None) of context
    ``index`` of a run with ``seed``, as ``cfg`` (a configuration's file)
    describes it."""
    rng = rng_for(seed, index)
    sizes = [int(s) for s in cfg["sizes"]]
    count = int(cfg["n_tuples"])
    modes = list(cfg.get("distinct_modes", range(len(sizes))))
    counts = cfg.get("value_counts")
    value_mode = len(modes) < len(sizes)
    if counts is not None and (sum(counts) != count or value_mode and (
            len(counts) != sizes[-1]
            or modes != list(range(len(sizes) - 1)))):
        raise ValueError("value_counts must deal n_tuples values, and as "
                         "the last mode's ids, over rows drawn on the "
                         "other modes")
    d_sizes = [sizes[k] for k in modes]
    probs = [power_law(sizes[k], float(cfg["exponents"][k])) for k in modes]
    space = math.prod(d_sizes)
    if space < count:
        raise ValueError(f"{count} distinct rows do not fit {space} cells")
    min0 = int(cfg.get("min_per_mode0", 0))
    if space <= RACE_CELLS:
        cells = _draw_racing(rng, d_sizes, probs, count, min0)
    elif min0:
        raise ValueError("min_per_mode0 needs a product space of at most "
                         f"{RACE_CELLS} cells")
    else:
        cells = _draw_rejecting(rng, d_sizes, probs, count)
    cols = []
    for n in reversed(d_sizes):
        cols.append(cells % n)
        cells = cells // n
    cols.reverse()
    values = None
    if counts is not None:
        ids = rng.permutation(np.repeat(np.arange(len(counts)), counts))
        if value_mode:
            cols.append(ids)
        values = (ids + float(cfg.get("value_offset", 0))).astype(np.float32)
    return np.stack(cols, 1).astype(np.int32), values


def scaled(cfg: dict, factor: float) -> dict:
    """``cfg`` with its row count shrunk by ``factor`` and each drawn
    mode by ``factor ** (1 / drawn modes)`` (at least 2 entities), so
    the density stays as it is: the same generator at a size a CPU test
    holds."""
    out = dict(cfg)
    sizes = [int(s) for s in cfg["sizes"]]
    modes = list(cfg.get("distinct_modes", range(len(sizes))))
    for k in modes:
        sizes[k] = max(2, int(round(sizes[k] * factor ** (1 / len(modes)))))
    counts = cfg.get("value_counts")
    if counts is not None:
        counts = [max(1, int(c * factor)) for c in counts]
        out["value_counts"] = counts
        out["n_tuples"] = sum(counts)
    else:
        out["n_tuples"] = max(1, int(cfg["n_tuples"] * factor))
    out["sizes"] = sizes
    if cfg.get("min_per_mode0"):
        out["min_per_mode0"] = min(int(cfg["min_per_mode0"]),
                                   out["n_tuples"] // sizes[0])
    return out
