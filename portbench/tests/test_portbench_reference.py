"""The plain reference against the port's CPU path (its kernels' plain
versions) on small contexts: prime and NOAC mining, and exact densities."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.data import contexts
from portbench.lib import compare
from portbench.reference import exact, mining
from repro_torch.core import BatchMiner, NOACMiner, batch

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
LEAVES = ("sig_lo", "sig_hi", "gen_count", "keep", "density",
          "cardinalities", "range_lo", "range_hi", "sorted_e")


def _config(name, factor):
    with open(CONFIGS / f"{name}.json") as f:
        return contexts.scaled(json.load(f), factor)


def _port_leaves(res):
    out = {k: getattr(res, k).numpy() for k in LEAVES}
    out["sig_lo"] = out["sig_lo"].view(np.uint32)
    out["sig_hi"] = out["sig_hi"].view(np.uint32)
    return out


def _assert_same(res, ref):
    got = _port_leaves(res)
    for k in LEAVES:
        assert compare.mismatches(got[k], ref[k]) == 0, k
    assert compare.rel_err(got["density"], ref["density_exact"]) < 2e-7


@pytest.mark.parametrize("name,variant,seed", [
    ("bibsonomy", "prime", 11), ("movielens-1m", "prime", 12),
    ("movielens-1m", "noac", 13), ("bibsonomy", "prime", 2**31 + 5),
    ("movielens-1m-ratings", "noac", 14),
    ("movielens-1m-ratings", "noac", 2**31 + 6)])
def test_reference_matches_port_on_config_contexts(name, variant, seed):
    cfg = _config(name, 0.003)
    tup, val = contexts.make_context(cfg, seed, 1)
    if variant == "prime":
        res = BatchMiner(cfg["sizes"], seed=cfg["hash_seed"],
                         device="cpu")(tup)
        ref = mining.mine(tup, cfg["sizes"], hash_seed=cfg["hash_seed"])
    else:
        res = NOACMiner(cfg["sizes"], delta=1.0, seed=cfg["hash_seed"],
                        device="cpu")(tup, val)
        ref = mining.mine(tup, cfg["sizes"], hash_seed=cfg["hash_seed"],
                          values=val, delta=1.0)
    _assert_same(res, ref)


@pytest.mark.parametrize("sizes", [(7, 9, 5), (30, 40, 12), (6, 5, 4, 3)])
def test_reference_matches_port_with_repeated_rows(sizes):
    rng = np.random.default_rng(len(sizes) * 100 + sizes[0])
    tup = np.stack([rng.integers(0, s, 400) for s in sizes],
                   1).astype(np.int32)
    res = BatchMiner(sizes, device="cpu")(tup)
    _assert_same(res, mining.mine(tup, sizes, hash_seed=0x5EED))


@pytest.mark.parametrize("delta,minsup", [(0.5, 2), (0.0, 0), (1.5, 1)])
def test_reference_matches_port_noac_windows(delta, minsup):
    rng = np.random.default_rng(7)
    sizes = (9, 11, 4)
    tup = np.stack([rng.integers(0, s, 500) for s in sizes], 1)
    _, first = np.unique(tup, axis=0, return_index=True)
    tup = tup[np.sort(first)].astype(np.int32)
    val = (rng.integers(0, 7, tup.shape[0]) * 0.5).astype(np.float32)
    res = NOACMiner(sizes, delta=delta, minsup=minsup,
                    device="cpu")(tup, val)
    _assert_same(res, mining.mine(tup, sizes, hash_seed=0x5EED, values=val,
                                  delta=delta, minsup=minsup))


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_exact_density_matches_port_dense_path(seed):
    cfg = _config("movielens-1m", 0.004)
    tup, _ = contexts.make_context(cfg, seed, 0)
    t = torch.from_numpy(tup)
    tens = batch.dense_tensor(t, cfg["sizes"])
    got = batch.exact_density_dense(tens, batch.fibers(tens, t)).numpy()
    want = exact.exact_densities(t, cfg["sizes"]).numpy()
    assert compare.rel_err(got, want) < 2e-7


def test_exact_density_counts_repeated_rows_once():
    rng = np.random.default_rng(5)
    sizes = (6, 7, 4)
    tup = np.stack([rng.integers(0, s, 300) for s in sizes],
                   1).astype(np.int32)
    inc = np.zeros(sizes, bool)
    inc[tuple(tup.T)] = True
    num, vol = exact.box_counts(torch.from_numpy(tup), sizes)
    for i in range(0, 300, 37):
        g, m, b = tup[i]
        x, y, z = inc[:, m, b], inc[g, :, b], inc[g, m, :]
        assert num[i] == inc[np.ix_(x, y, z)].sum()
        assert vol[i] == x.sum() * y.sum() * z.sum()


def test_generators_are_seeded_and_distinct():
    for name in ("bibsonomy", "movielens-1m", "movielens-1m-ratings"):
        cfg = _config(name, 0.003)
        a, va = contexts.make_context(cfg, 2**31 + 1, 2)
        b, vb = contexts.make_context(cfg, 2**31 + 1, 2)
        c, _ = contexts.make_context(cfg, 2**31 + 1, 3)
        assert np.array_equal(a, b) and not np.array_equal(a, c)
        assert a.shape == (cfg["n_tuples"], len(cfg["sizes"]))
        assert (a.max(0) < np.array(cfg["sizes"])).all() and a.min() >= 0
        cols = a if va is None else a[:, :2]
        assert np.unique(cols, axis=0).shape[0] == a.shape[0]
        if va is not None:
            assert np.array_equal(va, vb)
            stars = (va - cfg["value_offset"]).astype(np.int64)
            if a.shape[1] == 3:
                assert np.array_equal(stars, a[:, 2])
            assert np.bincount(stars).tolist() == cfg["value_counts"]
            assert np.bincount(a[:, 0]).min() >= cfg["min_per_mode0"]


def test_valued_context_deals_the_rows_of_the_star_mode_context():
    """One seed gives the (user, movie, star) context and the (user,
    movie) context valued by the star alike, row for row."""
    tri, tv = contexts.make_context(_config("movielens-1m", 0.003), 9, 0)
    duo, dv = contexts.make_context(
        _config("movielens-1m-ratings", 0.003), 9, 0)
    assert np.array_equal(tri[:, :2], duo) and np.array_equal(tv, dv)


def test_valued_context_has_windows_inside_key_segments():
    """The star varies inside key segments, so δ 1 windows are not whole
    segments: the δ-window layer has work to do."""
    cfg = _config("movielens-1m-ratings", 0.01)
    tup, val = contexts.make_context(cfg, 2**31 + 3, 0)
    win = mining.mine(tup, cfg["sizes"], hash_seed=cfg["hash_seed"],
                      values=val, delta=1.0)
    seg = mining.mine(tup, cfg["sizes"], hash_seed=cfg["hash_seed"],
                      values=val, delta=10.0)
    narrower = (win["range_hi"] - win["range_lo"]) \
        < (seg["range_hi"] - seg["range_lo"])
    assert narrower.mean(1).min() > 0.9
