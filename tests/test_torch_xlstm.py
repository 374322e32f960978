"""Parity of the port's xLSTM family (``models.xlstm`` and ``models.lm``'s
``xlstm`` branches) with the JAX package on the CPU, with the same weights
(the JAX init converted by ``from_jax_params``) and inputs drawn from a
seed with numpy.

* The parameter tree and the decode cache, leaf for leaf, on
  ``xlstm-smoke`` (4 layers: 2 groups of an mLSTM and an sLSTM block),
  its ``n_layers=1`` pattern (no group, a tail of 1) and
  ``slstm_every=0`` (mLSTM blocks only); the full width counted.
* Each block at smoke width and once at full width (d 768, 4 heads: the
  mLSTM's of 384, the sLSTM's of 192; B 1, S 64, ``ssm_chunk`` 32): the
  mLSTM in its one-shot form (S <= chunk), its chunked form (S = 4
  chunks) and at a length that is no multiple of the chunk (the one-shot
  form again), each with its state; both decode steps from a non-zero
  state.  Within 2e-5 of the row's (a state's: the leaf's) largest
  magnitude in float32, 2e-2 in bfloat16 (the sLSTM, whose ``hs`` is
  rounded to the compute dtype every step).
* The model in float32: forward, prefill, 4 greedy decode steps and
  every cache leaf within 1e-4 of the row's or leaf's largest magnitude
  (the hybrid test's cap), on the three patterns and on the smoke config
  at ``ssm_chunk`` 8 (the prefill's mLSTM in 4 chunks); the port's own
  prefill and decode against its forward, as ``tests/test_arch_smoke.py``
  holds the JAX package's.

Training, checkpoints, serving and the launchers are
``tests/test_torch_xlstm_train.py``'s; the mesh is
``tests/_torch_mesh_check.py``'s."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import lm as JL
from repro.models import xlstm as JX
from repro.models.api import get_model as jax_get_model
from repro.models.params import count_params, init_params

from repro_torch import configs as tcfg
from repro_torch.models import lm as L
from repro_torch.models import xlstm as TX
from repro_torch.models.api import get_model
from repro_torch.models.params import from_jax_params, tree_items

ARCH = "xlstm-125m"
B, S, MAX_LEN, STEPS = 2, 32, 48, 4
BLOCK_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_TOL = 1e-4
#: name -> config changes of the model cases
PATTERNS = {"smoke": {}, "no_group": {"n_layers": 1},
            "mlstm_only": {"slstm_every": 0}, "chunked": {"ssm_chunk": 8}}


def _configs(full=False, dtype="float32", **kw):
    get = (lambda m: m.get_config(ARCH)) if full else (
        lambda m: m.get_smoke_config(ARCH))
    return (dataclasses.replace(get(jcfg), dtype=dtype, **kw),
            dataclasses.replace(get(tcfg), dtype=dtype, **kw))


def _row_err(got, want) -> float:
    """The worst row's max |difference| over the row's max |want| (the
    last axis)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(-1), 1e-30)
    return float((np.abs(got - want).max(-1) / scale).max())


def _leaf_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not want.size:
        return 0.0
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _np(t) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a: np.ndarray, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)


def _tx(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16 if dtype == "bfloat16"
                                  else torch.float32)


def _defs(jc, kind):
    return (JL._mlstm_defs if kind == "mlstm" else JL._slstm_defs)(jc)


@functools.lru_cache(None)
def _block(kind, full=False):
    """One block's weights (the JAX package's init, with its zero and one
    leaves redrawn so that every term counts) as (JAX tree, port dict)."""
    jc, _ = _configs(full)
    p = {k: np.asarray(v) for k, v in init_params(
        _defs(jc, kind), jax.random.PRNGKey(4)).items()}
    rng = np.random.default_rng(6)
    for k in ("norm_scale", "b_i", "b_f"):
        if k in p:
            p[k] = (p[k] + rng.normal(0, 0.3, p[k].shape)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            dict(from_jax_params(p, device="cpu")))


def _x(s, d, seed=0, b=B):
    return np.random.default_rng(seed).normal(0, 1, (b, s, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_params_tree_and_counts_match_jax(pattern):
    jc, tc = _configs(**PATTERNS[pattern])
    jdefs = jax_get_model(jc).param_defs(jc)
    tdefs = get_model(tc).param_defs(tc)
    flat = [(tuple(k.key for k in p), tuple(d.shape), tuple(d.axes), d.init,
             d.scale) for p, d in jax.tree_util.tree_flatten_with_path(
                 jdefs, is_leaf=lambda x: hasattr(x, "axes"))[0]]
    assert flat == [(p, tuple(d.shape), tuple(d.axes), d.init, d.scale)
                    for p, d in tree_items(tdefs)]
    assert tc.n_params() == count_params(jdefs)
    jp = jax_get_model(jc).init(jc, jax.random.PRNGKey(0))
    tp = from_jax_params(jp, device="cpu")
    for (p, t), a in zip(tree_items(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a), err_msg=p)
    drawn = get_model(tc).init(tc, torch.Generator().manual_seed(0),
                               device="cpu")
    assert [(p, tuple(x.shape)) for p, x in tree_items(drawn)] == \
        [(p, tuple(x.shape)) for p, x in tree_items(tp)]


def test_full_width_count_is_the_jax_package_s():
    jc, tc = _configs(full=True)
    assert tc.n_params() == 188_884_992 == count_params(
        jax_get_model(jc).param_defs(jc))
    lay = get_model(tc).param_defs(tc)["layers"]
    assert sorted(lay) == ["mlstm_main", "slstm"]       # 12 % 4: no tail
    assert lay["mlstm_main"]["w_up"].shape == (3, 3, 768, 3072)
    assert lay["mlstm_main"]["wq"].shape == (3, 3, 1536, 1536)
    assert lay["slstm"]["r_gates"].shape == (3, 4, 4, 192, 192)
    assert lay["slstm"]["w_mlp_down"].shape == (3, 1024, 768)


@pytest.mark.parametrize("pattern", ["smoke", "no_group", "mlstm_only"])
@pytest.mark.parametrize("batch,dtype", [(3, "bfloat16"), (1, "float32")])
def test_cache_defs_and_init_cache_match_the_jax_package(pattern, batch,
                                                         dtype):
    jc, tc = _configs(**PATTERNS[pattern])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jd = JL.cache_defs(jc, batch, 40, jdt)
    td = L.cache_defs(tc, batch, 40, tdt)
    jl = jax.tree_util.tree_flatten_with_path(
        jd, is_leaf=lambda x: hasattr(x, "axes"))[0]
    tl = tree_items(td)
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in tl]
    for (_, j), (p, t) in zip(jl, tl):
        assert (t.shape, t.axes, t.fill) == (j.shape, j.axes, j.fill), p
        assert str(t.dtype)[6:] == str(np.dtype(j.dtype)), p
    assert not {"k", "v", "slot_pos"} & set(td)
    cache = L.init_cache(tc, batch, 40, tdt, device="cpu")
    for (p, t), a in zip(tree_items(cache), jax.tree.leaves(
            JL.init_cache(jc, batch, 40, jdt))):
        np.testing.assert_array_equal(_np(t), np.asarray(a, np.float32),
                                      err_msg=p)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(12, 16), (32, 8), (19, 8)],
                         ids=["one_shot", "chunked", "not_a_multiple"])
def test_mlstm_forward_and_state_match_jax(s, chunk):
    jc, tc = _configs(ssm_chunk=chunk)
    jp, tp = _block("mlstm")
    x = _x(s, jc.d_model)
    want = jax.jit(lambda p, x: JX.mlstm_forward(jc, p, x, True))(
        jp, jnp.asarray(x))
    got = TX.mlstm_forward(tc, tp, torch.from_numpy(x), return_state=True)
    assert _row_err(_np(got[0]), want[0]) <= BLOCK_TOL["float32"]
    for g, w, name in zip(got[1:], want[1:], "cnm"):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert _leaf_err(_np(g), w) <= BLOCK_TOL["float32"], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_and_state_match_jax(dtype):
    jc, tc = _configs(dtype=dtype)
    jp, tp = _block("slstm")
    x = _x(24, jc.d_model, seed=1)
    want = jax.jit(lambda p, x: JX.slstm_forward(jc, p, x, True))(
        jp, _jnp(x, dtype))
    got = TX.slstm_forward(tc, tp, _tx(x, dtype), return_state=True)
    tol = BLOCK_TOL[dtype]
    assert got[0].dtype == _tx(x, dtype).dtype
    assert _row_err(_np(got[0]), np.asarray(want[0], np.float32)) <= tol
    for g, w, name in zip(got[1], want[1], ("c", "n", "hs", "m")):
        assert g.shape == w.shape, name
        assert str(g.dtype)[6:] == str(np.dtype(w.dtype)), name
        assert _leaf_err(_np(g), np.asarray(w, np.float32)) <= tol, name


def test_decode_steps_from_a_state_match_jax():
    """Both decode steps from the state a 20-token forward leaves."""
    jc, tc = _configs()
    tol = BLOCK_TOL["float32"]
    x0, x1 = _x(20, jc.d_model, seed=2), _x(1, jc.d_model, seed=3)
    jp, tp = _block("mlstm")
    state = JX.mlstm_forward(jc, jp, jnp.asarray(x0), True)[1:]
    want = jax.jit(lambda p, x, *st: JX.mlstm_decode(jc, p, x, *st))(
        jp, jnp.asarray(x1), *state)
    got = TX.mlstm_decode(tc, tp, torch.from_numpy(x1),
                          *(torch.from_numpy(np.array(a)) for a in state))
    assert float(np.abs(np.asarray(state[0])).max()) > 0
    assert _row_err(_np(got[0]), want[0]) <= tol
    for g, w in zip(got[1:], want[1:]):
        assert _leaf_err(_np(g), w) <= tol
    jp, tp = _block("slstm")
    state = JX.slstm_forward(jc, jp, jnp.asarray(x0), True)[1]
    want = jax.jit(lambda p, x, st: JX.slstm_decode(jc, p, x, st))(
        jp, jnp.asarray(x1), state)
    got = TX.slstm_decode(tc, tp, torch.from_numpy(x1),
                          tuple(torch.from_numpy(np.array(a))
                                for a in state))
    assert _row_err(_np(got[0]), want[0]) <= tol
    for g, w in zip(got[1], want[1]):
        assert _leaf_err(_np(g), w) <= tol


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_at_full_width_match_jax(kind):
    """d 768, 4 heads (the mLSTM's of 384, the sLSTM's of 192), B 1,
    S 64 at ``ssm_chunk`` 32: the mLSTM's chunked form."""
    jc, tc = _configs(full=True, ssm_chunk=32)
    assert int(jc.d_model * jc.mlstm_proj) // jc.n_heads == 384
    jp, tp = _block(kind, full=True)
    x = _x(64, jc.d_model, seed=5, b=1)
    fwd = JX.mlstm_forward if kind == "mlstm" else JX.slstm_forward
    want = jax.jit(lambda p, x: fwd(jc, p, x, True))(jp, jnp.asarray(x))
    tfwd = TX.mlstm_forward if kind == "mlstm" else TX.slstm_forward
    got = tfwd(tc, tp, torch.from_numpy(x), return_state=True)
    tol = BLOCK_TOL["float32"]
    assert _row_err(_np(got[0]), want[0]) <= tol
    states = zip(got[1:], want[1:]) if kind == "mlstm" else zip(got[1],
                                                                 want[1])
    for g, w in states:
        assert g.shape == w.shape and _leaf_err(_np(g), w) <= tol


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _cache_items(cache) -> list:
    return [(p, _np(t).copy()) for p, t in tree_items(cache)]


@functools.lru_cache(None)
def _served(pattern):
    """The JAX package's forward, prefill and 4 greedy decode steps, and
    the port's fed the JAX tokens, with both caches after the prefill and
    after the last step."""
    jc, tc = _configs(**PATTERNS[pattern])
    jp = jax_get_model(jc).init(jc, jax.random.PRNGKey(0))
    tp = from_jax_params(jp, device="cpu")
    toks = np.random.default_rng(0).integers(1, 255, (B, S)).astype(
        np.int32)
    out = {"forward": (np.asarray(jax.jit(lambda p, t: JL.forward(
        jc, p, t))(jp, jnp.asarray(toks))[0]),
        L.forward(tc, tp, toks)[0].numpy())}
    jcache, jl = jax.jit(lambda p, t: JL.prefill(jc, p, t, MAX_LEN))(
        jp, jnp.asarray(toks))
    cache, tl = L.prefill(tc, tp, toks, MAX_LEN)
    out["prefill"] = (np.asarray(jl), tl.numpy())
    out["caches"] = [(jax.device_get(jcache), _cache_items(cache))]
    step = jax.jit(lambda p, c, t: JL.decode_step(jc, p, c, t))
    fed = []
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        fed.append((nxt, tl.argmax(-1).numpy()))
        jcache, jl = step(jp, jcache, jnp.asarray(nxt))
        cache, tl = L.decode_step(tc, tp, cache, torch.from_numpy(nxt))
        out[f"decode {i}"] = (np.asarray(jl), tl.numpy())
    out["caches"].append((jax.device_get(jcache), _cache_items(cache)))
    out["fed"] = fed
    return out


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_forward_prefill_and_decode_match_jax(pattern):
    served = _served(pattern)
    for name in ("forward", "prefill") + tuple(f"decode {i}"
                                               for i in range(STEPS)):
        want, got = served[name]
        assert np.isfinite(got).all(), name
        assert _row_err(got, want) <= MODEL_TOL, (name, _row_err(got, want))
    for want, got in served["fed"]:
        np.testing.assert_array_equal(got, want)
    for when, (jcache, items) in zip(("prefill", "decode"),
                                     served["caches"]):
        jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
        assert [tuple(k.key for k in p) for p, _ in jflat] == \
            [p for p, _ in items]
        for (_, w), (p, g) in zip(jflat, items):
            w = np.asarray(w)
            assert g.shape == w.shape, (when, p)
            if w.dtype.kind == "i":
                np.testing.assert_array_equal(g, w, err_msg=f"{when} {p}")
            else:
                assert _leaf_err(g, w) <= MODEL_TOL, (when, p,
                                                       _leaf_err(g, w))
    assert dict(served["caches"][1][1])[("pos",)] == S + STEPS


@pytest.mark.parametrize("pattern", ["smoke", "no_group", "chunked"])
def test_prefill_and_decode_match_the_port_s_forward(pattern):
    """prefill(S) against forward(S)'s last position, and a decode step
    against forward(S + 1)'s."""
    _, tc = _configs(**PATTERNS[pattern])
    tp = get_model(tc).init(tc, torch.Generator().manual_seed(1),
                            device="cpu")
    toks = np.random.default_rng(1).integers(1, 255, (B, S + 1))
    cache, lp = L.prefill(tc, tp, toks[:, :S], MAX_LEN)
    assert _row_err(lp.numpy(), L.forward(tc, tp, toks[:, :S])[0][:, -1]
                    .numpy()) <= MODEL_TOL
    cache, ld = L.decode_step(tc, tp, cache, toks[:, S])
    assert _row_err(ld.numpy(), L.forward(tc, tp, toks)[0][:, -1]
                    .numpy()) <= MODEL_TOL
    assert int(cache["pos"]) == S + 1


def test_rmsnorm_launches_and_no_position_read(monkeypatch):
    """With ``use_pallas`` every module-level norm goes through
    ``ops.rmsnorm``, at the plan's count: per group its mLSTM blocks',
    the sLSTM's block and inner norms, then ``out_norm`` (16 at
    xlstm-125m), in the prefill and in each decode step.  The cache has no
    ring, so a step does not depend on ``pos``."""
    from repro_torch.kernels import ops
    _, tc = _configs(use_pallas=True)
    tp = get_model(tc).init(tc, torch.Generator().manual_seed(2),
                            device="cpu")
    calls = []
    real = ops.rmsnorm

    def counted(x, w, eps=1e-6, **kw):
        calls.append(tuple(x.shape))
        return real(x, w, eps, **kw)

    monkeypatch.setattr(ops, "rmsnorm", counted)
    toks = np.random.default_rng(2).integers(1, 255, (B, 8))
    cache, _ = L.prefill(tc, tp, toks, 16)
    ng = tc.n_layers // tc.slstm_every
    plan = ng * (tc.slstm_every - 1) + 2 * ng + 1
    full = tcfg.get_config(ARCH)
    assert (full.n_layers // full.slstm_every) * (full.slstm_every + 1) \
        + 1 == 16
    assert len(calls) == plan
    moved = {k: (v if k == "pos" else {n: t.clone() for n, t in v.items()})
             for k, v in cache.items()}
    moved["pos"] = torch.tensor(999, dtype=torch.int32)
    calls.clear()
    _, want = L.decode_step(tc, tp, cache, toks[:, 0])
    assert len(calls) == plan and all(c[-1] == tc.d_model for c in calls)
    _, got = L.decode_step(tc, tp, moved, toks[:, 0])
    assert torch.equal(got, want)
