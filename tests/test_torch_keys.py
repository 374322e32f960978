"""Parity of the port's packed-key module (``repro_torch.core.keys``) with
``repro.core.keys``: plans, device packing (against the JAX packer and the
numpy ``pack_host``), the order-preserving float encoding on special
values, field extraction, δ-query words, ``drop_low_bits`` and
``search_words``.  Inputs come from fixed numpy seeds; integer outputs are
compared bit for bit as uint32/int32."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, u32
from repro.core import keys as JK
from repro_torch.core import keys as TK

SIZES = [(7, 6, 5), (250, 700, 22), (2337, 67464, 28920), (3, 4),
         (5, 3, 2, 7), (2048, 2048, 2048), (6040, 3952, 5)]

# finite float32 specials: ±0, smallest normal, ±max
SPECIALS = np.array([0.0, -0.0, 1.1754944e-38, -1.1754944e-38, 1.0, -1.0,
                     3.4028235e38, -3.4028235e38, 0.5, 1000.0, -7.25],
                    np.float32)
SUBNORMALS = np.array([1e-45, -1e-45, 3e-42, -1.1e-38], np.float32)


def _rows(sizes, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, s, n, dtype=np.int32)
                     for s in sizes], 1)


def _values(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1000, 1000, n).astype(np.float32)
    v[:SPECIALS.size] = SPECIALS[:n]
    return v


def _pack_both(plan_j, plan_t, rows, vals, dom):
    jw = plan_j.pack_device(jnp.asarray(rows),
                            None if vals is None else jnp.asarray(vals),
                            domain=None if dom is None else jnp.asarray(dom))
    tw = plan_t.pack_device(torch.from_numpy(rows),
                            None if vals is None else torch.from_numpy(vals),
                            domain=None if dom is None
                            else torch.from_numpy(dom))
    return jw, tw


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("lane", ["none", "float", "rank"])
def test_plans_and_pack_device_match_jax_and_host(sizes, lane):
    rows = _rows(sizes, 300, seed=len(sizes) + sizes[0])
    vals = None if lane == "none" else _values(300, seed=sizes[-1])
    dom = JK.value_domain_host(vals) if lane == "rank" else None
    if vals is not None:
        np.testing.assert_array_equal(TK.value_domain_host(vals),
                                      JK.value_domain_host(vals))
    slots = None if dom is None else dom.shape[0]
    jplans = JK.plan_context_keys(sizes, vals is not None, slots)
    tplans = TK.plan_context_keys(sizes, vals is not None, slots)
    assert ([dataclasses.asdict(p) for p in jplans]
            == [dataclasses.asdict(p) for p in tplans])
    for pj, pt in zip(jplans, tplans):
        if not pt.fits:
            continue
        jw, tw = _pack_both(pj, pt, rows, vals, dom)
        assert len(tw) == pt.words
        for a, b in zip(tw, jw):
            assert_same(a, b, "pack_device")
        host = pt.pack_host(rows, vals, dom)
        np.testing.assert_array_equal(host, pj.pack_host(rows, vals, dom))
        words = [w.numpy().view(np.uint32).astype(np.uint64) for w in tw]
        dev = ((words[0] << np.uint64(32)) | words[1]) if pt.words == 2 \
            else words[0]
        np.testing.assert_array_equal(dev, host)


def test_rank_lane_subnormals_follow_numpy():
    """Rank lanes of subnormal values equal the numpy host packer.  (The
    JAX device packer differs here on the CPU: XLA:CPU flushes subnormals
    to zero in comparisons, so its ``searchsorted`` ranks them as 0.)"""
    sizes = (7, 6, 5)
    rows = _rows(sizes, 64, seed=9)
    vals = _values(64, seed=10)
    vals[20:20 + SUBNORMALS.size] = SUBNORMALS
    dom = TK.value_domain_host(vals)
    for plan in TK.plan_context_keys(sizes, True, dom.shape[0]):
        words = plan.pack_device(torch.from_numpy(rows),
                                 torch.from_numpy(vals),
                                 torch.from_numpy(dom))
        np.testing.assert_array_equal(
            words[0].numpy().view(np.uint32).astype(np.uint64),
            plan.pack_host(rows, vals, dom))


def test_float_sort_bits_specials_and_inverse():
    rng = np.random.default_rng(11)
    v = np.concatenate([SPECIALS, SUBNORMALS, rng.standard_normal(200).astype(
        np.float32) * np.float32(1e30), rng.standard_normal(200).astype(
        np.float32) * np.float32(1e-40)]).astype(np.float32)
    enc = TK.float_sort_bits(torch.from_numpy(v))
    assert_same(enc, TK.float_sort_bits_host(v), "host")
    assert_same(enc, JK.float_sort_bits(jnp.asarray(v)), "jax")
    back = TK.float_from_sort_bits(enc).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), v.view(np.uint32))
    # strictly order-preserving on the values other than -0.0
    w = v[~((v == 0) & np.signbit(v))]
    e = TK.float_sort_bits_host(w)
    order = np.argsort(w, kind="stable")
    assert (np.diff(e[order].astype(np.int64)) >= 0).all()
    assert ((w[:, None] == w[None, :])
            == (e[:, None] == e[None, :])).all()


@pytest.mark.parametrize("sizes", [(7, 6, 5), (2048, 2048, 2048),
                                   (6040, 3952, 5), (3, 4)])
@pytest.mark.parametrize("lane", ["float", "rank"])
def test_extract_and_delta_query_words(sizes, lane):
    rows = _rows(sizes, 257, seed=3)
    vals = _values(257, seed=4)
    dom = JK.value_domain_host(vals) if lane == "rank" else None
    slots = None if dom is None else dom.shape[0]
    for pj, pt in zip(JK.plan_context_keys(sizes, True, slots),
                      TK.plan_context_keys(sizes, True, slots)):
        if not pt.fits:
            continue
        jw, tw = _pack_both(pj, pt, rows, vals, dom)
        assert_same(pt.extract_entity(tw), pj.extract_entity(jw), "entity")
        assert_same(pt.extract_values(
            tw, None if dom is None else torch.from_numpy(dom)),
            pj.extract_values(jw, None if dom is None else jnp.asarray(dom)),
            "values")
        rng = np.random.default_rng(pt.k)
        lane_codes = rng.integers(0, 1 << pt.value_bits, 257,
                                  dtype=np.uint64).astype(np.uint32)
        qj = pj.delta_query_words(jw, jnp.asarray(lane_codes))
        qt = pt.delta_query_words(tw, u32(lane_codes))
        for a, b in zip(qt, qj):
            assert_same(a, b, "delta_query_words")


@pytest.mark.parametrize("nw,shift", [(nw, s) for nw in (1, 2)
                                      for s in (0, 1, 5, 17, 31, 32, 33, 40,
                                                63) if s < 32 * nw])
def test_drop_low_bits(nw, shift):
    rng = np.random.default_rng(shift)
    words = [rng.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)
             for _ in range(nw)]
    words[0][:8] = 0xFFFFFFFF                      # sign bit set
    got = TK.drop_low_bits(tuple(u32(w) for w in words), shift)
    want = JK.drop_low_bits(tuple(jnp.asarray(w) for w in words), shift)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same(a, b, "drop_low_bits")


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("upper", [False, True])
def test_search_words(nw, upper):
    rng = np.random.default_rng(nw * 10 + upper)
    bits = 32 * nw
    keys = np.sort(rng.integers(0, 2**bits - 1, 500, dtype=np.uint64)
                   if nw == 2 else rng.integers(0, 2**32, 500,
                                                dtype=np.uint64))
    keys[100:140] = keys[100]                       # a run of equal keys
    keys = np.sort(keys)
    queries = np.concatenate([keys[rng.integers(0, 500, 200)],
                              rng.integers(0, 2**bits - 1, 200,
                                           dtype=np.uint64),
                              np.array([0, 2**bits - 1], np.uint64)])

    def split(k):
        lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (k >> np.uint64(32)).astype(np.uint32)
        return (hi, lo) if nw == 2 else (lo,)

    got = TK.search_words(tuple(u32(w) for w in split(keys)),
                          tuple(u32(w) for w in split(queries)), upper)
    want = JK.search_words(tuple(jnp.asarray(w) for w in split(keys)),
                           tuple(jnp.asarray(w) for w in split(queries)),
                           upper)
    assert_same(got, want, "search_words")
    np.testing.assert_array_equal(
        got.numpy(), np.searchsorted(keys, queries,
                                     side="right" if upper else "left"))


@pytest.mark.parametrize("backend", ["radix", "lax"])
@pytest.mark.parametrize("nw", [1, 2])
def test_sort_with_payload(backend, nw):
    rng = np.random.default_rng(7 + nw)
    keys = rng.integers(0, 2**(16 * nw), 700, dtype=np.uint64) << \
        np.uint64(16 * nw - 8)                       # ties, high bit set
    words = [(keys >> np.uint64(32)).astype(np.uint32),
             keys.astype(np.uint32)] if nw == 2 else [keys.astype(np.uint32)]
    pay = np.arange(700, dtype=np.int32)[::-1].copy()
    (sw, (sp,)) = TK.sort_with_payload(
        tuple(u32(w) for w in words), (torch.from_numpy(pay),),
        backend=backend, live_bits=32 * nw)
    jw, (jp,) = JK.sort_with_payload(
        tuple(jnp.asarray(w) for w in words), (jnp.asarray(pay),),
        backend="lax")
    for a, b in zip(sw, jw):
        assert_same(a, b, "sorted words")
    assert_same(sp, jp, "payload")
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(sp.numpy(), pay[order])
