"""Generators for the paper's experimental datasets (§5.1, §6).

K1, K2, K3 are defined in closed form in the paper and reproduced exactly.
The real-world datasets (IMDB top-250, MovieLens, BibSonomy, FrameNet
tri-frames) are not shipped offline; ``*_like`` generators emulate their
published shape statistics (sizes, #tuples, density from the paper's
Table 2 and §5.1) so that the benchmark harness exercises the same regime.
All generators are deterministic given the seed.

A numpy-only copy of ``repro.data.synthetic``: both packages draw the same
contexts from the same seed.
"""
from __future__ import annotations

import numpy as np

from ..core.context import PolyadicContext


def k1_dense_cube(n: int = 60) -> PolyadicContext:
    """K1 = (G,M,B, G×M×B \\ {(g,m,b) | g=m=b}),  |I| = n^3 - n (§5.1)."""
    g, m, b = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                          indexing="ij")
    triples = np.stack([g.ravel(), m.ravel(), b.ravel()], 1).astype(np.int32)
    keep = ~((triples[:, 0] == triples[:, 1]) &
             (triples[:, 1] == triples[:, 2]))
    return PolyadicContext((n, n, n), triples[keep])


def k2_three_cuboids(n: int = 50) -> PolyadicContext:
    """K2 = three disjoint n^3 cuboids,  |I| = 3·n^3 (§5.1)."""
    blocks = []
    for i in range(3):
        g, m, b = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                              indexing="ij")
        t = np.stack([g.ravel() + i * n, m.ravel() + i * n,
                      b.ravel() + i * n], 1)
        blocks.append(t)
    triples = np.concatenate(blocks).astype(np.int32)
    return PolyadicContext((3 * n, 3 * n, 3 * n), triples)


def k3_dense_4d(n: int = 30) -> PolyadicContext:
    """K3 = dense 4-ary cuboid (A1..A4, A1×A2×A3×A4), |I| = n^4 (§5.1).

    The paper's worst case for the reducers: maximal input size and number
    of duplicates; the correct output is the single cluster (A1,A2,A3,A4).
    """
    idx = np.indices((n, n, n, n)).reshape(4, -1).T.astype(np.int32)
    return PolyadicContext((n, n, n, n), idx)


def random_context(sizes, n_tuples: int, seed: int = 0,
                   values: bool = False) -> PolyadicContext:
    """Uniform random context (with optional many-valued float values)."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, s, size=n_tuples, dtype=np.int32) for s in sizes]
    vals = rng.uniform(0, 1000, n_tuples).astype(np.float32) if values else None
    ctx = PolyadicContext(tuple(sizes), np.stack(cols, 1), vals)
    return ctx


def _power_law_ids(rng, n: int, count: int, alpha: float = 1.3):
    p = 1.0 / np.arange(1, n + 1) ** alpha
    p /= p.sum()
    return rng.choice(n, size=count, p=p).astype(np.int32)


def imdb_like(seed: int = 0) -> PolyadicContext:
    """IMDB top-250 regime: 250 movies × ~3k tags × ~20 genres, 3,818
    triples, density ≈ 8.7e-4 (paper Table 2). Tags/genres power-law."""
    rng = np.random.default_rng(seed)
    n_obj, n_tag, n_genre, t = 250, 700, 22, 3818
    movies = rng.integers(0, n_obj, t).astype(np.int32)
    tags = _power_law_ids(rng, n_tag, t)
    genres = _power_law_ids(rng, n_genre, t, alpha=1.0)
    return PolyadicContext((n_obj, n_tag, n_genre),
                           np.stack([movies, tags, genres], 1))


def movielens_like(n_tuples: int = 100_000, seed: int = 0,
                   values: bool = True) -> PolyadicContext:
    """MovieLens regime: users × movies × ratings(1-5 stars) [12]. The
    third mode is the rating bucket as in the paper's tricontext usage;
    ``values`` carries the raw star value for δ-mining."""
    rng = np.random.default_rng(seed)
    n_users, n_movies = 6040, 3952
    users = _power_law_ids(rng, n_users, n_tuples, alpha=1.1)
    movies = _power_law_ids(rng, n_movies, n_tuples, alpha=1.2)
    stars = rng.integers(1, 6, n_tuples).astype(np.int32)
    vals = stars.astype(np.float32) if values else None
    return PolyadicContext((n_users, n_movies, 5),
                           np.stack([users, movies, stars - 1], 1), vals)


def bibsonomy_like(n_tuples: int = 816_197, seed: int = 0,
                   scale: float = 1.0) -> PolyadicContext:
    """BibSonomy regime (paper Table 2): 2,337 users × 67,464 tags ×
    28,920 bookmarks, 816,197 triples, density 1.8e-7. ``scale`` shrinks
    all modes and the tuple count proportionally for CI-sized runs."""
    rng = np.random.default_rng(seed)
    nu = max(2, int(2337 * scale))
    nt = max(2, int(67464 * scale))
    nb = max(2, int(28920 * scale))
    t = max(1, int(n_tuples * scale))
    users = _power_law_ids(rng, nu, t, alpha=1.2)
    tags = _power_law_ids(rng, nt, t, alpha=1.4)
    bookmarks = _power_law_ids(rng, nb, t, alpha=1.1)
    return PolyadicContext((nu, nt, nb),
                           np.stack([users, tags, bookmarks], 1))


def semantic_frames_like(n_tuples: int = 100_000, seed: int = 0
                         ) -> PolyadicContext:
    """FrameNet tri-frame regime of the paper's §6 (subject-verb-object
    triples with DepCC frequencies) — used by the NOAC benchmarks."""
    rng = np.random.default_rng(seed)
    ns, nv, no = 5000, 1200, 5000
    subj = _power_law_ids(rng, ns, n_tuples, alpha=1.3)
    verb = _power_law_ids(rng, nv, n_tuples, alpha=1.5)
    obj = _power_law_ids(rng, no, n_tuples, alpha=1.3)
    freq = np.round(rng.pareto(1.5, n_tuples) * 10 + 1).astype(np.float32)
    return PolyadicContext((ns, nv, no), np.stack([subj, verb, obj], 1), freq)
