"""Pure-python/numpy reference implementations (the test oracles).
A copy of ``repro.core.reference`` on the port's own context type.

These follow the paper literally:

* ``online_oac_prime``   — Algorithm 1 (online prime OAC-triclustering):
  dictionaries PrimesOA/OC/AC updated per triple; each tricluster stores
  *references* (here: dict keys) into the dictionaries.
* ``multimodal_clusters``— §3.1 cumuli + the three-stage M/R semantics of
  §4.1 (Algorithms 2-7): cluster per generating tuple, dedup by cluster,
  density estimated as  #generating_tuples / volume  (Algorithm 7).
* ``noac``               — §3.2/§4.3 many-valued δ-triclustering with
  minimal density and per-mode minimal cardinality constraints.
* ``exact_density``      — |box ∩ I| / volume (the exact quantity the paper
  names as an open problem; used to validate our beyond-paper kernel).

Everything returns plain python structures; tests diff them against the
port's engines, and ``chip_smoke.py`` holds the dense path's exact
numerators on the card against :func:`exact_density`.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Iterable, Optional

import numpy as np

from .context import PolyadicContext


def _cluster_key(cluster: tuple[frozenset, ...]) -> tuple:
    return tuple(tuple(sorted(c)) for c in cluster)


# ---------------------------------------------------------------------------
# Online prime OAC-triclustering (paper Algorithm 1)
# ---------------------------------------------------------------------------

class OnlineOACPrime:
    """Online algorithm; triadic only, mirroring the paper's Alg. 1."""

    def __init__(self):
        self.primes_oa: dict[tuple, set] = defaultdict(set)  # (g,m) -> {b}
        self.primes_oc: dict[tuple, set] = defaultdict(set)  # (g,b) -> {m}
        self.primes_ac: dict[tuple, set] = defaultdict(set)  # (m,b) -> {g}
        # tricluster = pointers (keys) into the dictionaries, per Alg.1 l.5
        self.triclusters: list[tuple[tuple, tuple, tuple]] = []

    def add(self, triples: Iterable[tuple[int, int, int]]) -> None:
        for (g, m, b) in triples:
            self.primes_oa[(g, m)].add(b)
            self.primes_oc[(g, b)].add(m)
            self.primes_ac[(m, b)].add(g)
            self.triclusters.append(((m, b), (g, b), (g, m)))

    def materialise(self) -> list[tuple[frozenset, frozenset, frozenset]]:
        """Dereference the pointers: one (extent, intent, modus) per triple."""
        out = []
        for (mb, gb, gm) in self.triclusters:
            out.append((frozenset(self.primes_ac[mb]),
                        frozenset(self.primes_oc[gb]),
                        frozenset(self.primes_oa[gm])))
        return out

    def unique(self) -> list[tuple[frozenset, frozenset, frozenset]]:
        seen, out = set(), []
        for t in self.materialise():
            k = _cluster_key(t)
            if k not in seen:
                seen.add(k)
                out.append(t)
        return out


def online_oac_prime(ctx: PolyadicContext):
    if ctx.arity != 3:
        raise ValueError("online_oac_prime is triadic")
    algo = OnlineOACPrime()
    algo.add(map(tuple, ctx.tuples.tolist()))
    return algo


# ---------------------------------------------------------------------------
# Multimodal clustering with three-stage M/R semantics (paper §3.1 + §4.1)
# ---------------------------------------------------------------------------

def cumulus(ctx: PolyadicContext, tup: tuple[int, ...], k: int) -> frozenset:
    """cum(i, k) = { e | i with mode k replaced by e is in I }   (§3.1)."""
    mask = np.ones(ctx.num_tuples, dtype=bool)
    for j, e in enumerate(tup):
        if j != k:
            mask &= ctx.tuples[:, j] == e
    return frozenset(ctx.tuples[mask, k].tolist())


def multimodal_clusters(ctx: PolyadicContext, theta: float = 0.0):
    """Three-stage semantics: returns
       (per_tuple_clusters, unique_clusters, stage3_density, kept)

    * per_tuple_clusters[i] — the cluster generated by tuples[i]
    * unique_clusters       — dedup'd list (first-occurrence order)
    * stage3_density        — paper Alg. 7 estimate: #generating/volume
      (counting *distinct* generating tuples, as reducer keys are unique)
    * kept                  — unique clusters passing density >= theta
    """
    # Stage 1: cumuli per (subrelation, mode) key.
    cum: list[dict[tuple, set]] = [defaultdict(set) for _ in range(ctx.arity)]
    for row in ctx.tuples.tolist():
        for k in range(ctx.arity):
            sub = tuple(row[:k] + row[k + 1:])
            cum[k][sub].add(row[k])
    # Stage 2: assemble the cluster of each generating tuple.
    per_tuple = []
    for row in ctx.tuples.tolist():
        cluster = tuple(
            frozenset(cum[k][tuple(row[:k] + row[k + 1:])])
            for k in range(ctx.arity))
        per_tuple.append(cluster)
    # Stage 3: dedup + density estimate + filter.
    gen: dict[tuple, set] = defaultdict(set)
    order: dict[tuple, tuple] = {}
    for row, cluster in zip(map(tuple, ctx.tuples.tolist()), per_tuple):
        k = _cluster_key(cluster)
        gen[k].add(row)
        order.setdefault(k, cluster)
    unique = list(order.values())
    density = {}
    kept = []
    for k, cluster in order.items():
        vol = int(np.prod([len(c) for c in cluster]))
        density[k] = len(gen[k]) / vol
        if density[k] >= theta:
            kept.append(cluster)
    return per_tuple, unique, density, kept


def exact_density(ctx: PolyadicContext, cluster: tuple[frozenset, ...]) -> float:
    """|X_1 × ... × X_N ∩ I| / Π|X_k|  — exact density (beyond-paper)."""
    mask = np.ones(ctx.num_tuples, dtype=bool)
    for k, comp in enumerate(cluster):
        mask &= np.isin(ctx.tuples[:, k], list(comp))
    inside = np.unique(ctx.tuples[mask], axis=0)
    vol = int(np.prod([len(c) for c in cluster]))
    return len(inside) / vol


# ---------------------------------------------------------------------------
# Many-valued δ-triclustering / NOAC (paper §3.2 + §4.3)
# ---------------------------------------------------------------------------

def _delta_component(ctx: PolyadicContext, tup, v0, k: int,
                     delta: float) -> frozenset:
    """δ-operator along mode k for generating tuple ``tup`` with value v0."""
    mask = np.ones(ctx.num_tuples, dtype=bool)
    for j, e in enumerate(tup):
        if j != k:
            mask &= ctx.tuples[:, j] == e
    mask &= np.abs(ctx.values - v0) <= delta
    return frozenset(ctx.tuples[mask, k].tolist())


def noac(ctx: PolyadicContext, delta: float, rho_min: float = 0.0,
         minsup: int = 0):
    """General OAC algorithm (paper Alg. 8) with δ-operators.

    Validity check = per-mode cardinality >= minsup and (approximate,
    generating-triple-based) density >= rho_min; density measured the same
    way as the M/R stage 3 so that both engines agree. Returns unique valid
    triclusters in first-occurrence order.
    """
    if ctx.values is None:
        # Regular triclusters: W={0,1}, δ=0 reduces to prime operators (§3.2).
        ctx = PolyadicContext(ctx.sizes, ctx.tuples,
                              np.zeros(ctx.num_tuples, np.float32), ctx.names)
    clusters: dict[tuple, set] = {}
    gen: dict[tuple, set] = defaultdict(set)
    order: list[tuple] = []
    for row, v0 in zip(ctx.tuples.tolist(), ctx.values.tolist()):
        cluster = tuple(_delta_component(ctx, row, v0, k, delta)
                        for k in range(ctx.arity))
        key = _cluster_key(cluster)
        if key not in clusters:
            clusters[key] = cluster
            order.append(key)
        gen[key].add(tuple(row))
    out = []
    for key in order:
        cluster = clusters[key]
        if any(len(c) < minsup for c in cluster):
            continue
        vol = int(np.prod([len(c) for c in cluster]))
        if len(gen[key]) / vol < rho_min:
            continue
        out.append(cluster)
    return out
