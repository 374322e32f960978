"""Parity of the port's sorted-run store (``repro_torch.core.runs``) with
the JAX package's (``repro.core.runs``): random add / upsert / delete
interleavings give the same log, survivor table and merged permutations;
the padding, window and chunking helpers agree; checkpoints written by
either package load in the other (framed and legacy), and a damaged
framed file raises ``CheckpointCorruptError``."""
import numpy as np
import pytest

from _torch_parity import apply_op, gen_ops
from repro.core import keys as JK
from repro.core import runs as JR
from repro_torch.core import keys as TK
from repro_torch.core import runs as TR

SIZES = (7, 6, 5)


def _stores(sizes, valued, **kw):
    return (JR.RunStore(JK.plan_context_keys(sizes, with_values=valued),
                        **kw),
            TR.RunStore(TK.plan_context_keys(sizes, with_values=valued),
                        **kw))


def _assert_tables_equal(a, b):
    (ra, va), (rb, vb) = a.table(), b.table()
    np.testing.assert_array_equal(ra, rb)
    assert (va is None) == (vb is None)
    if va is not None:
        np.testing.assert_array_equal(va.view(np.uint32), vb.view(np.uint32))


def _assert_runs_equal(a, b):
    assert len(a.runs) == len(b.runs)
    for ra, rb in zip(a.runs, b.runs):
        for x, y in zip(ra.keys + ra.idx, rb.keys + rb.idx):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("radix", [True, False])
@pytest.mark.parametrize("valued", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_interleavings_same_store(seed, valued, radix):
    rng = np.random.default_rng(seed)
    ops = gen_ops(rng, SIZES, 14, valued)
    j, t = _stores(SIZES, valued, radix=radix)
    for op in ops:
        apply_op(j, op)
        apply_op(t, op)
        assert (j.count, j.dead, j.covered) == (t.count, t.dead, t.covered)
        np.testing.assert_array_equal(j.alive, t.alive)
        _assert_runs_equal(j, t)
    assert j.stats == t.stats
    j.prepare()
    t.prepare()
    _assert_tables_equal(j, t)
    if j.count:
        for cap in (None, TR.snapshot_cap(t.count), 2 * t.count + 3):
            pj, pt = j.perms(cap), t.perms(cap)
            assert pj.dtype == pt.dtype == np.int32
            np.testing.assert_array_equal(pj, pt)


def test_non_incremental_store_keeps_no_runs():
    big = (1 << 20, 1 << 20, 1 << 20, 1 << 20)      # an 80-bit key
    rng = np.random.default_rng(9)
    rows = np.stack([rng.integers(0, 64, 30) for _ in big], 1)
    j, t = _stores(big, False)
    assert not j.incremental and not t.incremental
    for s in (j, t):
        s.add(rows)
        s.upsert(rows[:5])
        s.delete(rows[5:9])
        s.prepare()
        assert s.perms() is None and s.runs == []
    _assert_tables_equal(j, t)


@pytest.mark.parametrize("count", [1, 2, 3, 5, 64, 65, 1000, 816_197])
@pytest.mark.parametrize("multiple", [1, 3, 8])
def test_snapshot_cap(count, multiple):
    got = TR.snapshot_cap(count, multiple)
    assert got == JR.snapshot_cap(count, multiple)
    assert got >= count and got % multiple == 0
    if multiple == 1:
        assert got & (got - 1) == 0


@pytest.mark.parametrize("valued", [False, True])
@pytest.mark.parametrize("extra", [0, 1, 13])
def test_padded_perms_and_table(valued, extra):
    rng = np.random.default_rng(extra + 7 * valued)
    ops = gen_ops(rng, SIZES, 10, valued)
    j, t = _stores(SIZES, valued)
    for op in ops:
        apply_op(j, op)
        apply_op(t, op)
    j.prepare()
    t.prepare()
    assert t.count > 0
    cap = t.count + extra
    rows, vals = t.table()
    jp = JR.padded_perms(j.runs[0], j.plans, rows[:1],
                         None if vals is None else vals[:1], t.count, cap)
    tp = TR.padded_perms(t.runs[0], t.plans, rows[:1],
                         None if vals is None else vals[:1], t.count, cap)
    np.testing.assert_array_equal(jp, tp)
    jr, jv = JR.padded_table(rows, vals, cap)
    tr, tv = TR.padded_table(rows, vals, cap)
    np.testing.assert_array_equal(jr, tr)
    if valued:
        np.testing.assert_array_equal(jv, tv)
    # the pad rows are row 0, at row 0's key position in every mode
    for k, plan in enumerate(t.plans):
        keys = plan.pack_host(tr, tv)[tp[k]]
        assert np.all(keys[1:] >= keys[:-1])


@pytest.mark.parametrize("budget", [None, 1, 4, 7, 50])
@pytest.mark.parametrize("form", ["table", "chunks"])
@pytest.mark.parametrize("with_values", [False, True])
def test_iter_chunks(budget, form, with_values):
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 9, (23, 3)).astype(np.int32)
    vals = rng.uniform(0, 5, 23).astype(np.float32)
    if form == "table":
        args = (rows, vals if with_values else None)
    else:
        cuts = [0, 5, 6, 17, 23]
        args = ([rows[a:b] for a, b in zip(cuts, cuts[1:])],
                [vals[a:b] for a, b in zip(cuts, cuts[1:])]
                if with_values else None)
    want = list(JR.iter_chunks(*args, chunk_budget=budget,
                               with_values=True))
    got = list(TR.iter_chunks(*args, chunk_budget=budget,
                              with_values=True))
    assert len(got) == len(want)
    for (rg, vg), (rw, vw) in zip(got, want):
        np.testing.assert_array_equal(rg, rw)
        np.testing.assert_array_equal(vg, vw)
        if budget:
            assert rg.shape[0] <= budget


def test_merge_offset_and_shard_of_rows():
    rng = np.random.default_rng(4)
    plans = TK.plan_context_keys(SIZES, with_values=False)
    runs = []
    for lo in (0, 20):
        rows = rng.integers(0, 5, (20, 3)).astype(np.int32)
        keys = [p.pack_host(rows) for p in plans]
        order = [np.argsort(k, kind="stable") for k in keys]
        runs.append(TR.Run([k[o] for k, o in zip(keys, order)],
                           [(o + lo).astype(np.int32) for o in order]))
    jruns = [JR.Run(r.keys, r.idx) for r in runs]
    got, want = (TR.merge_runs(*runs),
                 JR.merge_runs(*jruns))
    for x, y in zip(got.keys + got.idx, want.keys + want.idx):
        np.testing.assert_array_equal(x, y)
    got, want = TR.offset_run(runs[0], 9), JR.offset_run(jruns[0], 9)
    for x, y in zip(got.idx, want.idx):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    id_plan = TK.plan_mode_key(SIZES, 0, with_values=False)
    jid = JK.plan_mode_key(SIZES, 0, with_values=False)
    rows = rng.integers(0, 5, (200, 3)).astype(np.int32)
    for n in (1, 2, 5, 8):
        np.testing.assert_array_equal(TR.shard_of_rows(rows, id_plan, n),
                                      JR.shard_of_rows(rows, jid, n))


# ---------------------------------------------------------------------------
# Checkpoints across packages
# ---------------------------------------------------------------------------

def _streamed(pkg, keys, valued, seed=5):
    rng = np.random.default_rng(seed)
    store = pkg.RunStore(keys.plan_context_keys(SIZES, with_values=valued))
    for op in gen_ops(rng, SIZES, 12, valued):
        apply_op(store, op)
    return store


def _legacy(blob):
    return {k: blob[k] for k in ("buffer", "count", "values") if k in blob}


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("valued", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_loads_across_packages(tmp_path, direction, valued,
                                          legacy):
    src, dst = ((JR, JK), (TR, TK)) if direction == "jax_to_torch" \
        else ((TR, TK), (JR, JK))
    store = _streamed(*src, valued)
    blob = store.checkpoint()
    if legacy:
        blob = _legacy(blob)
    path = str(tmp_path / "ckpt.npz")
    if legacy:      # a pre-frame checkpoint: a plain npz of the fields
        np.savez(path, buffer=blob["buffer"], scalars=np.asarray(
            [blob["count"], 0, 1, 0, int(valued)], np.int64),
            meta_json=np.frombuffer(b"{}", np.uint8),
            **({"values": blob["values"]} if valued else {}))
    else:
        src[0].save_checkpoint(blob, path, meta={"stream_version": 7})
    loaded, meta = dst[0].load_checkpoint(path)
    assert meta == ({} if legacy else {"stream_version": 7})
    back, _ = src[0].load_checkpoint(path)
    for k in ("buffer", "count", "covered", "incremental", "with_values"):
        assert np.array_equal(loaded[k], back[k]), k
    plans = dst[1].plan_context_keys(SIZES, with_values=valued)
    restored = dst[0].RunStore.restore(loaded, plans)
    if legacy:
        assert restored.covered == 0 and restored.runs == []
    restored.prepare()
    store.prepare()
    _assert_tables_equal(store, restored)
    if store.count:
        np.testing.assert_array_equal(store.perms(), restored.perms())


def test_checkpoint_restores_without_plans(tmp_path):
    store = _streamed(JR, JK, True, seed=11)
    path = str(tmp_path / "c.npz")
    JR.save_checkpoint(store.checkpoint(), path)
    blob, _ = TR.load_checkpoint(path)
    restored = TR.RunStore.restore(blob)         # plans from the sizes
    assert restored.plans == TK.plan_context_keys(SIZES, with_values=True)
    assert restored.runs and restored.covered == restored.count
    _assert_runs_equal(store, restored)


@pytest.mark.parametrize("damage", ["truncate", "flip", "trailing",
                                    "header"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_damaged_checkpoint_raises(tmp_path, damage, writer):
    store = _streamed(TR, TK, True, seed=2)
    path = tmp_path / "c.npz"
    (JR if writer == "jax" else TR).save_checkpoint(store.checkpoint(),
                                                    str(path))
    raw = bytearray(path.read_bytes())
    assert raw[:4] == TR.CKPT_MAGIC == JR.CKPT_MAGIC
    if damage == "truncate":
        raw = raw[:len(raw) // 2]
    elif damage == "flip":
        raw[len(raw) // 2] ^= 0x10
    elif damage == "trailing":
        raw += b"\0"
    else:
        raw = raw[:len(TR.CKPT_MAGIC) + 5]
    path.write_bytes(bytes(raw))
    with pytest.raises(TR.CheckpointCorruptError):
        TR.load_checkpoint(str(path))
    assert not (tmp_path / "c.npz.tmp").exists()
