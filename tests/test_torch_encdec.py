"""Parity of the port's enc-dec family (``models.encdec``) with the JAX
package on the CPU, at ``seamless-smoke`` (2 encoder and 2 decoder
layers, d 64, 4 heads of 16, MHA, 20-dim frames, ``frontend_len`` 32),
with the same weights (the JAX init converted by ``from_jax_params``) and
frames and tokens drawn from a seed with numpy.

Tolerances (float32), each the largest |difference| over the largest
|value| of the row (the last axis) or of the leaf:

* 2e-5 (``tests/test_kernels.py``'s float32 tolerance): the encoder
  output and the cross K/V, the cross attention and a decoder block;
* 1e-4 (``MODEL_TOL``, the hybrid and xLSTM tests' cap): the logits of
  ``forward``, ``prefill`` and every decode step, and the cache's K/V
  rings.  Four layers of float32 leave ~2e-5 of the row's max in those
  logits whichever package computes them: the JAX package's own lie
  6e-6 to 2.4e-5 from a float64 evaluation on these inputs (seeds 0-3),
  the port's 6e-6 to 2.7e-5, so the two can part by twice that (2.8e-5
  at the fourth decode step).  :func:`test_forward_float64_witness` holds
  the port no farther from float64 than the JAX package, up to a factor
  of 2;
* the cache's integer leaves equal; the port's own prefill against its
  forward's row within 1e-6 of the row's max and a decode step within
  1e-5 (the JAX package shows 0.0 and 2.9e-6);
* bfloat16: a block (the cross attention, a decoder block) within 2e-2
  (``tests/test_kernels.py``'s); the model's logits no farther from the
  JAX package's jitted ones than twice the JAX package's own eager run
  is (one bf16 rounding more or less per fused op: 0.05 to 0.13 of the
  row's max at seeds 0-2), plus 2e-2.

Training is ``tests/test_torch_train.py``'s (``test_train_steps_match_jax``),
the mesh ``tests/_torch_mesh_check.py``'s."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import encdec as JE
from repro.models.api import get_model as jax_get_model
from repro.models.params import count_params
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.sharding.rules import MeshRules as JaxMeshRules

from repro_torch import configs as tcfg
from repro_torch.kernels import ops
from repro_torch.models import encdec as E
from repro_torch.models import lm as L
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.api import get_model
from repro_torch.sharding import MeshRules
from repro_torch.models.params import from_jax_params, tree_items
from repro_torch.serve import ServeEngine

ARCH = "seamless-m4t-large-v2"
B, S, SE, MAX_LEN, STEPS = 2, 8, 9, 16, 4
TOL, MODEL_TOL, BF16_TOL = 2e-5, 1e-4, 2e-2


def _configs(dtype="float32", **kw):
    return (dataclasses.replace(jcfg.get_smoke_config(ARCH), dtype=dtype,
                                **kw),
            dataclasses.replace(tcfg.get_smoke_config(ARCH), dtype=dtype,
                                **kw))


def _row_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(-1), 1e-30)
    return float((np.abs(got - want).max(-1) / scale).max())


def _leaf_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _np(t) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@functools.lru_cache(None)
def _weights(seed=0):
    """(JAX parameters, the port's, the port's in float64)."""
    jc, _ = _configs()
    jp = jax_get_model(jc).init(jc, jax.random.PRNGKey(seed))
    return (jp, from_jax_params(jp, device="cpu"),
            from_jax_params(jp, device="cpu", dtype=torch.float64))


def _inputs(se=SE, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    jc, _ = _configs()
    frames = rng.normal(0, 1, (b, se, jc.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, jc.vocab_size, (b, s + 1)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:s], np.full((b, 1), -100, np.int32)],
                            1)
    return {"frames": frames, "tokens": toks[:, :s], "labels": labels,
            "next": toks[:, s]}


def _jnp(batch, dtype="float32"):
    return {k: (jnp.asarray(v).astype(jnp.bfloat16)
                if k == "frames" and dtype == "bfloat16" else jnp.asarray(v))
            for k, v in batch.items() if k != "next"}


def _cache_items(cache) -> list:
    return [(p, _np(t).copy()) for p, t in tree_items(cache)]


@functools.lru_cache(None)
def _served(se, dtype="float32"):
    """The JAX package's prefill and STEPS greedy decode steps, and the
    port's fed the JAX tokens, with both caches after the prefill and
    after the last step."""
    jc, tc = _configs(dtype)
    jp, tp, _ = _weights()
    batch = _inputs(se)
    inputs = {"frames": batch["frames"], "tokens": batch["tokens"]}
    jcache, jl = jax.jit(lambda p, x: JE.prefill(jc, p, x, MAX_LEN))(
        jp, _jnp(inputs))
    cache, tl = E.prefill(tc, tp, inputs, MAX_LEN)
    out = {"prefill": (np.asarray(jl), tl.numpy()),
           "caches": [(jax.device_get(jcache), _cache_items(cache))],
           "fed": []}
    step = jax.jit(lambda p, c, t: JE.decode_step(jc, p, c, t))
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        out["fed"].append((nxt, tl.argmax(-1).numpy()))
        jcache, jl = step(jp, jcache, jnp.asarray(nxt))
        cache, tl = E.decode_step(tc, tp, cache, torch.from_numpy(nxt))
        out[f"decode {i}"] = (np.asarray(jl), tl.numpy())
    out["caches"].append((jax.device_get(jcache), _cache_items(cache)))
    return out


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------

def test_params_tree_and_counts_match_jax():
    jc, tc = _configs()
    jdefs = jax_get_model(jc).param_defs(jc)
    tdefs = get_model(tc).param_defs(tc)
    assert get_model(tc).param_defs is E.param_defs
    flat = [(tuple(k.key for k in p), tuple(d.shape), tuple(d.axes), d.init,
             d.scale) for p, d in jax.tree_util.tree_flatten_with_path(
                 jdefs, is_leaf=lambda x: hasattr(x, "axes"))[0]]
    assert flat == [(p, tuple(d.shape), tuple(d.axes), d.init, d.scale)
                    for p, d in tree_items(tdefs)]
    assert tc.n_params() == count_params(jdefs)
    jp, tp, _ = _weights()
    for (p, t), a in zip(tree_items(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a), err_msg=p)
    full = tcfg.get_config(ARCH)
    assert full.n_params() == 2_034_866_176 == jcfg.get_config(
        ARCH).n_params()
    drawn = get_model(tc).init(tc, torch.Generator().manual_seed(0),
                               device="cpu")
    assert [(p, tuple(x.shape)) for p, x in tree_items(drawn)] == \
        [(p, tuple(x.shape)) for p, x in tree_items(tp)]


@pytest.mark.parametrize("batch,dtype", [(3, "bfloat16"), (1, "float32")])
def test_init_cache_matches_the_jax_package(batch, dtype):
    """The declarations leaf for leaf (the ring on ``long_seq`` at batch
    1, the cross K/V ``frontend_len`` long on ``kv_seq``), the default
    dtype bfloat16, and the filled cache."""
    jc, tc = _configs()
    kw = {} if dtype == "bfloat16" else {"dtype": jnp.float32}
    jd = JE.cache_defs(jc, batch, 40, **kw)
    td = get_model(tc).cache_defs(tc, batch, 40, **(
        {} if dtype == "bfloat16" else {"dtype": torch.float32}))
    assert sorted(jd) == sorted(td)
    for k in jd:
        j, t = jd[k], td[k]
        assert (t.shape, t.axes, t.fill) == (j.shape, j.axes, j.fill), k
        assert str(t.dtype)[6:] == str(np.dtype(j.dtype)), k
    assert td["cross_k"].shape[2] == tc.frontend_len
    cache = get_model(tc).init_cache(tc, batch, 40, **(
        {} if dtype == "bfloat16" else {"dtype": torch.float32}),
        device="cpu")
    jcache = JE.init_cache(jc, batch, 40, **kw)
    for k in jcache:
        assert cache[k].dtype == getattr(torch, str(np.dtype(
            jcache[k].dtype))), k
        np.testing.assert_array_equal(_np(cache[k]), np.asarray(
            jcache[k], np.float32), err_msg=k)
    # the dry run's stand-ins (ROADMAP A13g) equal JAX's leaf for leaf
    # (shape, dtype, PartitionSpec) on a (1, 1) mesh; ``pos`` is a real
    # CPU scalar one short of full, which the decode step reads
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    js = JE.cache_structs(jc, batch, 40, JaxMeshRules(mesh), **kw)
    ts = get_model(tc).cache_structs(
        tc, batch, 40, MeshRules(make_local_mesh(device="cpu")),
        **({} if dtype == "bfloat16" else {"dtype": torch.float32}))
    assert sorted(js) == sorted(ts)
    for k in js:
        j, t = js[k], ts[k]
        assert t.shape == tuple(j.shape), k
        assert str(t.dtype)[6:] == str(np.dtype(j.dtype)), k
        assert tuple(t.sharding.spec) == tuple(
            e for e in j.sharding.spec), k
    assert int(ts["pos"].local()) == 39 and ts["k"].local().is_meta


# ---------------------------------------------------------------------------
# encoder and cross attention
# ---------------------------------------------------------------------------

def test_encode_matches_jax():
    jc, tc = _configs()
    jp, tp, _ = _weights()
    frames = _inputs()["frames"]
    want = jax.jit(lambda p, f: JE.encode(jc, p, f))(jp, jnp.asarray(frames))
    got = E.encode(tc, tp, torch.from_numpy(frames))
    assert _row_err(got[0].numpy(), want[0]) <= TOL
    for g, w, name in zip(got[1:], want[1:], ("cross_k", "cross_v")):
        assert g.shape == w.shape == (tc.n_layers, B, SE, tc.n_kv_heads,
                                      tc.head_dim), name
        assert _leaf_err(g.numpy(), w) <= TOL, name


def test_cross_attention_matches_jax():
    jc, tc = _configs()
    jp, tp, _ = _weights()
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (B, 5, jc.d_model)).astype(np.float32)
    kv = rng.normal(0, 1, (2, B, SE, jc.n_kv_heads, jc.head_dim)).astype(
        np.float32)
    jpc = jax.tree.map(lambda a: a[1], jp["decoder"]["cross"])
    want = jax.jit(lambda p, x, k, v: JE._cross_attention(jc, p, x, k, v))(
        jpc, jnp.asarray(x), jnp.asarray(kv[0]), jnp.asarray(kv[1]))
    tpc = {k: v[1] for k, v in tp["decoder"]["cross"].items()}
    got = E._cross_attention(tc, tpc, torch.from_numpy(x),
                             torch.from_numpy(kv[0]),
                             torch.from_numpy(kv[1]))
    assert _row_err(got.numpy(), want) <= TOL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@functools.lru_cache(None)
def _forward(seed=0):
    """(JAX logits, JAX loss, port logits, port loss, float64 logits)."""
    jc, tc = _configs()
    jp, tp, tp64 = _weights(seed)
    batch = _inputs(seed=seed)
    jl = jax.jit(lambda p, b: JE.forward(jc, p, b)[0])(jp, _jnp(batch))
    jloss = jax.jit(lambda p, b: JE.loss_fn(jc, p, b)[0])(jp, _jnp(batch))
    tl, aux = E.forward(tc, tp, batch)
    tloss, metrics = E.loss_fn(tc, tp, batch)
    assert float(aux) == 0.0 and float(metrics["aux"]) == 0.0
    assert torch.equal(metrics["nll"], tloss)
    t64 = dataclasses.replace(tc, dtype="float64")
    l64 = E.forward(t64, tp64, batch)[0]
    return (np.asarray(jl), float(jloss), tl.numpy(), float(tloss),
            l64.numpy())


def test_forward_and_loss_match_jax():
    jl, jloss, tl, tloss, _ = _forward()
    assert tl.shape == jl.shape == (B, S, 256) and tl.dtype == np.float32
    assert _row_err(tl, jl) <= MODEL_TOL, _row_err(tl, jl)
    assert abs(tloss - jloss) <= TOL * abs(jloss), (tloss, jloss)


def test_forward_float64_witness():
    """The port's float32 logits are no farther from a float64 evaluation
    of the same weights and inputs than twice the JAX package's."""
    jl, _, tl, _, l64 = _forward()
    assert _row_err(tl, l64) <= 2 * _row_err(jl, l64) + 1e-6, (
        _row_err(tl, l64), _row_err(jl, l64))


@pytest.mark.parametrize("se", [SE, 32], ids=["frames_9", "frontend_len"])
def test_prefill_and_decode_match_jax(se):
    """prefill's logits and every cache leaf (the cross K/V as long as the
    frames), then STEPS greedy decode steps fed the JAX tokens."""
    served = _served(se)
    want, got = served["prefill"]
    assert _row_err(got, want) <= MODEL_TOL, _row_err(got, want)
    for i in range(STEPS):
        want, got = served[f"decode {i}"]
        assert np.isfinite(got).all()
        assert _row_err(got, want) <= MODEL_TOL, (i, _row_err(got, want))
    for want, got in served["fed"]:
        np.testing.assert_array_equal(got, want)
    for when, (jcache, items) in zip(("prefill", "decode"),
                                     served["caches"]):
        assert sorted(jcache) == [p[0] for p, _ in items]
        for p, g in items:
            w = np.asarray(jcache[p[0]])
            assert g.shape == w.shape, (when, p)
            if w.dtype.kind == "i":
                np.testing.assert_array_equal(g, w, err_msg=f"{when} {p}")
            else:
                tol = TOL if p[0].startswith("cross") else MODEL_TOL
                assert _leaf_err(g, w) <= tol, (when, p, _leaf_err(g, w))
        assert dict(items)[("cross_k",)].shape[2] == se
    assert dict(served["caches"][1][1])[("pos",)] == S + STEPS


def test_prefill_and_decode_match_the_port_s_forward():
    """prefill(S) against forward(S)'s last row within 1e-6 of the row's
    max, a decode step against forward(S + 1)'s within 1e-5."""
    _, tc = _configs()
    tp = get_model(tc).init(tc, torch.Generator().manual_seed(1),
                            device="cpu")
    batch = _inputs(seed=1)
    full = dict(batch, tokens=np.concatenate(
        [batch["tokens"], batch["next"][:, None]], 1))
    cache, lp = E.prefill(tc, tp, batch, MAX_LEN)
    assert _row_err(lp.numpy(), E.forward(tc, tp, batch)[0][:, -1]
                    .numpy()) <= 1e-6
    cache, ld = E.decode_step(tc, tp, cache, batch["next"])
    assert _row_err(ld.numpy(), E.forward(tc, tp, full)[0][:, -1]
                    .numpy()) <= 1e-5
    assert int(cache["pos"]) == S + 1


def test_kernel_switches_equal_the_defaults_on_the_cpu(monkeypatch):
    """``attn_impl="pallas"`` and ``use_pallas=True`` on CPU tensors run the
    plain versions: the same numbers as the defaults, through the ops at
    the plan's counts (``forward``: one ``flash_attention`` a decoder
    layer; every norm: 2 an encoder layer, ``enc_out_norm``, 3 a decoder
    layer, ``out_norm``; a decode step: one ``decode_attention`` a
    layer)."""
    _, tc = _configs()
    on = dataclasses.replace(tc, attn_impl="pallas", use_pallas=True)
    _, tp, _ = _weights()
    batch = _inputs()
    calls = {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    n_enc, n_dec = 2 * tc.enc_layers + 1, 3 * tc.n_layers + 1
    assert torch.equal(E.forward(on, tp, batch)[0],
                       E.forward(tc, tp, batch)[0])
    assert calls == {"flash_attention": tc.n_layers, "decode_attention": 0,
                     "rmsnorm": n_enc + n_dec}
    c_on, l_on = E.prefill(on, tp, batch, MAX_LEN)
    c_off, l_off = E.prefill(tc, tp, batch, MAX_LEN)
    assert torch.equal(l_on, l_off)
    assert calls["rmsnorm"] == 2 * (n_enc + n_dec)
    for _ in range(2):
        c_on, l_on = E.decode_step(on, tp, c_on, batch["next"])
        c_off, l_off = E.decode_step(tc, tp, c_off, batch["next"])
        assert torch.equal(l_on, l_off)
    assert calls == {"flash_attention": tc.n_layers,
                     "decode_attention": 2 * tc.n_layers,
                     "rmsnorm": 2 * (n_enc + n_dec) + 2 * n_dec}
    full = tcfg.get_config(ARCH)
    assert (2 * full.enc_layers + 1, 3 * full.n_layers + 1) == (49, 73)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_block_matches_jax(dtype):
    """``_dec_block`` (self attention, cross attention, SwiGLU) on the
    same input and cross K/V, layer 1's weights."""
    jc, tc = _configs(dtype)
    jp, tp, _ = _weights()
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (B, S, jc.d_model)).astype(np.float32)
    kv = rng.normal(0, 1, (2, B, SE, jc.n_kv_heads, jc.head_dim)).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jpl = jax.tree.map(lambda a: a[1], jp["decoder"])
    want = jax.jit(lambda p, x, k, v: JE._dec_block(
        jc, p, x, jnp.arange(S, dtype=jnp.int32), k, v))(
        jpl, jnp.asarray(x).astype(jdt), jnp.asarray(kv[0]).astype(jdt),
        jnp.asarray(kv[1]).astype(jdt))
    tpl = {k: (v[1] if isinstance(v, torch.Tensor)
               else {n: t[1] for n, t in v.items()})
           for k, v in tp["decoder"].items()}
    got = E._dec_block(tc, tpl, torch.from_numpy(x).to(tdt),
                       torch.arange(S, dtype=torch.int32),
                       torch.from_numpy(kv[0]).to(tdt),
                       torch.from_numpy(kv[1]).to(tdt))
    assert got.dtype == tdt
    tol = TOL if dtype == "float32" else BF16_TOL
    assert _row_err(_np(got), np.asarray(want, np.float32)) <= tol


def test_bfloat16_matches_jax():
    jc, tc = _configs("bfloat16")
    jp, tp, _ = _weights()
    batch = _inputs()
    want = np.asarray(jax.jit(lambda p, b: JE.forward(jc, p, b)[0])(
        jp, _jnp(batch, "bfloat16")), np.float32)
    with jax.disable_jit():
        eager = np.asarray(JE.forward(jc, jp, _jnp(batch, "bfloat16"))[0],
                           np.float32)
    tol = 2 * _row_err(eager, want) + BF16_TOL
    got = E.forward(tc, tp, batch)[0]
    assert got.dtype == torch.float32
    assert _row_err(got.numpy(), want) <= tol, (_row_err(got.numpy(), want),
                                                tol)
    served = _served(SE, "bfloat16")
    for name in ["prefill"] + [f"decode {i}" for i in range(STEPS)]:
        want, got = served[name]
        assert _row_err(got, want) <= tol, (name, _row_err(got, want), tol)
    cache = dict(served["caches"][0][1])
    assert cache[("cross_k",)].shape == (tc.n_layers, B, SE, 4, 16)


def test_serve_engine_refuses_the_family():
    """``ServeEngine`` passes tokens only (as the JAX package's); the
    family serves through ``Model.prefill`` / ``decode_step`` with frames,
    and the decoder-only entries of ``models.lm`` refuse it."""
    _, tc = _configs()
    _, tp, _ = _weights()
    with pytest.raises(ValueError, match="Model.prefill"):
        ServeEngine(tc, tp, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="models.encdec"):
        L.param_defs(tc)
    with pytest.raises(ValueError, match="models.encdec"):
        L.prefill(tc, tp, np.zeros((1, 2), np.int32), 8)
