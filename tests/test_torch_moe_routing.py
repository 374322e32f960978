"""Parity of the port's MoE-routing slice with the JAX package on the CPU:
configs, token pipeline, parameter trees, the model primitives
(``common``), the LM forward, and the routing pass as a whole — routes,
the routing context and the mined clusters.

Both packages compute with the same weights (the JAX tree converted by
``from_jax_params``) on the same tokens.  In fp32 the routes, context
triples and every ``PipelineResult`` leaf are identical; in bf16 a one-ulp
difference can flip a top-k choice, so bf16 is held to tolerances
(``tests/test_kernels.py``: fp32 2e-5, bf16 2e-2) and to an agreement
share, never to equality.  Model-level outputs in fp32 are held to the
repo's model-parity tolerance (``tests/test_models_parity.py``: 2e-4):
the smoke configs' weights make scores of magnitude ~10, where the two
packages' sums in other orders differ by ~1e-5 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import BatchMiner as JaxBatchMiner
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.models import common as JC
from repro.models import lm as JL
from repro.models import telemetry as JT
from repro.models.api import get_model as jax_get_model

from repro_torch import configs as tcfg
from repro_torch.configs import base as base_config
from repro_torch.core import BatchMiner
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import mine_moe_routing
from repro_torch.models import common as C
from repro_torch.models import lm as L
from repro_torch.models import telemetry as T
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.api import get_model, input_specs
from repro_torch.models.layout import layout
from repro_torch.sharding import MeshRules
from repro_torch.models.params import (ParamDef, count_params,
                                       from_jax_params, init_params,
                                       layer_slice)

from _torch_parity import assert_results_identical

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": TOL["bfloat16"]}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
MOE_ARCHS = ["granite-moe-3b-a800m", "mixtral-8x7b"]
B, S = 4, 64


def _t(a, dtype=None) -> torch.Tensor:
    """A JAX/numpy array as a CPU tensor (bf16 goes through fp32, which
    holds it exactly)."""
    a = np.asarray(a)
    if a.dtype.kind in "fV":                 # V: ml_dtypes' bfloat16
        t = torch.from_numpy(np.array(a, np.float32))
        return t.to(dtype) if dtype is not None else t
    return torch.from_numpy(np.array(a))


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _configs(arch, dtype="float32", **kw):
    jc = dataclasses.replace(jcfg.get_smoke_config(arch), dtype=dtype, **kw)
    tc = dataclasses.replace(tcfg.get_smoke_config(arch), dtype=dtype, **kw)
    return jc, tc


def _weights(jc, seed=0):
    jp = jax_get_model(jc).init(jc, jax.random.PRNGKey(seed))
    return jp, from_jax_params(jp, device="cpu")


def _tokens(jc):
    return JaxTokenPipeline(jc, B, S, seed=0).batch_at(0)["tokens"]


def _rand(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(JDT[dtype]), _t(x, TDT[dtype])


# ---------------------------------------------------------------------------
# configs, tokens, parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jcfg.ARCHS)
def test_configs_match_the_jax_package(arch):
    assert tcfg.ARCHS == jcfg.ARCHS
    for get in ("get_config", "get_smoke_config"):
        jc, tc = getattr(jcfg, get)(arch), getattr(tcfg, get)(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        if jc.family in ("dense", "moe"):
            want = JL.param_defs(jc)
            assert L.param_defs(tc) == want
            assert tc.n_params() == jc.n_params()
            assert tc.n_active_params() == jc.n_active_params()
        else:
            with pytest.raises(NotImplementedError, match="ROADMAP A13"):
                L.param_defs(tc)
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    assert tcfg.cells() == jcfg.cells()


def test_full_width_granite_moe_parameter_count():
    assert tcfg.get_config("granite-moe-3b-a800m").n_params() == 3_298_793_472


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b",
                                  "internvl2-76b"])
def test_token_pipeline_matches_the_jax_package(arch):
    jc, tc = jcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch)
    jp, tp = JaxTokenPipeline(jc, 3, 40, seed=5), TokenPipeline(tc, 3, 40,
                                                                seed=5)
    for step in (0, 3):
        jb, tb = jp.batch_at(step), tp.batch_at(step)
        assert jb.keys() == tb.keys()
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    assert tp.prompts(4, 9) == jp.prompts(4, 9)


def test_init_params_follows_the_declared_distributions():
    defs = {"embed": ParamDef((300, 40), (None, None), "normal", 1.0),
            "layers": {"w": ParamDef((3, 400, 50), (None,) * 3),
                       "n": ParamDef((3, 50), (None, None), "ones"),
                       "z": ParamDef((7,), (None,), "zeros")}}
    tree = init_params(defs, torch.Generator().manual_seed(1), device="cpu")
    assert list(tree.state_dict()) == ["embed", "layers.n", "layers.w",
                                       "layers.z"]
    assert tree["layers"]["w"].shape == (3, 400, 50)
    assert not any(p.requires_grad for p in tree.parameters())
    assert abs(float(tree["embed"].std()) - 1.0) < 0.02
    assert abs(float(tree["layers"]["w"].std()) - 400 ** -0.5) < 1e-3
    assert torch.equal(tree["layers"]["n"], torch.ones(3, 50))
    assert torch.equal(tree["layers"]["z"], torch.zeros(7))
    again = init_params(defs, torch.Generator().manual_seed(1),
                        device="cpu")
    other = init_params(defs, torch.Generator().manual_seed(2),
                        device="cpu")
    assert torch.equal(again["layers"]["w"], tree["layers"]["w"])
    assert not torch.equal(other["layers"]["w"], tree["layers"]["w"])
    assert count_params(defs) == sum(p.numel() for p in tree.parameters())
    bf = init_params(defs, torch.Generator().manual_seed(1), torch.bfloat16,
                     "cpu")
    assert bf["embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="cannot draw"):
        init_params(defs, torch.Generator(), device="meta")


def test_from_jax_params_keeps_paths_shapes_and_values():
    jc = jcfg.get_smoke_config("granite-moe-3b-a800m")
    jp, tp = _weights(jc)
    want = {".".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    got = tp.state_dict()
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert got["layers.moe.w_gate"].shape == (jc.n_layers, jc.n_experts,
                                              jc.d_model, jc.d_ff)
    sl = layer_slice(tp["layers"], 1)
    np.testing.assert_array_equal(sl["attn"]["wq"].numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"][1]))
    mine = get_model(tcfg.get_smoke_config("granite-moe-3b-a800m")).init(
        tcfg.get_smoke_config("granite-moe-3b-a800m"),
        torch.Generator().manual_seed(0), device="cpu")
    assert sorted(mine.state_dict()) == sorted(want)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_match(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _rand(rng, (2, 9, 4, 16), dtype)
    sc = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        _np32(C.rmsnorm(tx, _t(sc), 1e-5)),
        _np32(JC.rmsnorm(jx, jnp.asarray(sc), 1e-5)), **TOL[dtype])
    pos = np.arange(9, dtype=np.int32)
    jcos, jsin = JC.rope_tables(jnp.asarray(pos), 16, 1e4)
    tcos, tsin = C.rope_tables(torch.from_numpy(pos), 16, 1e4)
    for got, want in ((tcos, jcos), (tsin, jsin)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["float32"])
    np.testing.assert_allclose(
        _np32(C.apply_rope(tx, tcos, tsin)),
        _np32(JC.apply_rope(jx, jcos, jsin)), **TOL[dtype])
    # use_pallas=True runs ops.rmsnorm: on a CPU tensor its plain version
    np.testing.assert_allclose(
        _np32(C.rmsnorm(tx, _t(sc), 1e-5, use_pallas=True)),
        _np32(JC.rmsnorm(jx, jnp.asarray(sc), 1e-5)), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,q_block", [("einsum", 2048), ("blocked", 24),
                                          ("pallas", 2048)])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-0.6b"])
def test_attention_matches(arch, impl, q_block, dtype):
    """Sliding window (mixtral-smoke, window 32 < S) and QK-norm (qwen3);
    ``blocked`` with a ragged tail block (64 = 2 x 24 + 16)."""
    jc, tc = _configs(arch, dtype)
    jp, tp = _weights(jc, seed=1)
    rng = np.random.default_rng(1)
    jx, tx = _rand(rng, (2, S, jc.d_model), dtype)
    pos = np.arange(S, dtype=np.int32)
    pa = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    want = JC.attention(jc, pa, jx, jnp.asarray(pos), impl=impl,
                        q_block=q_block)
    got = C.attention(tc, layer_slice(tp["layers"]["attn"], 0), tx,
                      torch.from_numpy(pos), impl=impl, q_block=q_block)
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(_np32(got), _np32(want), **MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches(dtype):
    jc, tc = _configs("qwen3-0.6b", dtype)
    jp, tp = _weights(jc, seed=2)
    jx, tx = _rand(np.random.default_rng(2), (2, 16, jc.d_model), dtype)
    want = JC.swiglu(jax.tree.map(lambda a: a[1], jp["layers"]["mlp"]), jx)
    got = C.swiglu(layer_slice(tp["layers"]["mlp"], 1), tx)
    np.testing.assert_allclose(_np32(got), _np32(want), **MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches(arch, dtype):
    """Dispatch, expert SwiGLU and the ordered combine; the 0.8 capacity
    factor drops routes, and S == 1 takes the dense all-expert path."""
    jc, tc = _configs(arch, dtype, capacity_factor=0.8)
    jp, tp = _weights(jc, seed=3)
    pj = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    pt = layer_slice(tp["layers"]["moe"], 0)
    rng = np.random.default_rng(3)
    for shape in ((3, 40, jc.d_model), (2, 1, jc.d_model)):
        jx, tx = _rand(rng, shape, dtype)
        jy, jaux = JC.moe_ffn(jc, pj, jx)
        ty, taux = C.moe_ffn(tc, pt, tx)
        assert ty.dtype == TDT[dtype]
        np.testing.assert_allclose(_np32(ty), _np32(jy), **MODEL_TOL[dtype])
        np.testing.assert_allclose(float(taux), float(jaux), **TOL["float32"])
    jx, tx = _rand(rng, (3, 40, jc.d_model), dtype)
    dropped = float(C.moe_dropped_fraction(tc, pt, tx))
    assert dropped == pytest.approx(float(JC.moe_dropped_fraction(jc, pj, jx)))
    assert dropped > 0
    # on a (1, 1) mesh every collective is the identity: bit for bit
    lay = layout(tc, MeshRules(make_local_mesh(device="cpu")), tx.shape[0],
                 L.param_defs)
    for impl in ("shard_map", "gspmd"):
        c = dataclasses.replace(tc, moe_impl=impl)
        for a, b in zip(C.moe_ffn(c, pt, tx, lay), C.moe_ffn(c, pt, tx)):
            assert torch.equal(a, b), impl


def test_top_k_takes_the_lower_index_on_ties():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    tv, ti = C.top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the LM forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_on_dense_qwen3(dtype):
    jc, tc = _configs("qwen3-0.6b", dtype)
    jp, tp = _weights(jc, seed=4)
    toks = _tokens(jc)[:2, :32]
    jl, jaux = JL.forward(jc, jp, jnp.asarray(toks))
    tl, taux = get_model(tc).forward(tc, tp, {"tokens": toks})
    assert tl.shape == (2, 32, tc.vocab_size) and tl.dtype == torch.float32
    _check_logits(tl, jl, dtype)
    assert float(taux) == float(jaux) == 0.0


def test_forward_with_patch_frontend_matches_on_internvl2():
    """The vision stub: patch embeddings prepended through the adapter,
    untied head."""
    jc, tc = _configs("internvl2-76b")
    jp, tp = _weights(jc, seed=5)
    batch = JaxTokenPipeline(jc, 2, 16, seed=0).batch_at(0)
    jl, _ = JL.forward(jc, jp, jnp.asarray(batch["tokens"]),
                       jnp.asarray(batch["patches"]))
    tl, _ = get_model(tc).forward(tc, tp, batch)
    assert tl.shape == (2, 16 + jc.frontend_len, jc.vocab_size)
    _check_logits(tl, jl, "float32")


def _check_logits(tl, jl, dtype):
    want = np.asarray(jl)
    tol = dict(MODEL_TOL[dtype])
    if dtype == "bfloat16":
        # the bf16 residual stream rounds each element to 2**-8 relative;
        # the fp32 head sums d_model of them, so the error scales with
        # the logits' magnitude, not with each logit
        tol["atol"] = 2e-2 * float(np.abs(want).max())
    np.testing.assert_allclose(tl.numpy(), want, **tol)


def test_unported_entry_points_name_their_roadmap_item():
    tc = tcfg.get_smoke_config("qwen3-0.6b")
    model = get_model(tc)
    # a mesh is taken: on a (1, 1) mesh the entries equal those without
    rules = MeshRules(make_local_mesh(device="cpu"))
    params = model.init(tc, torch.Generator().manual_seed(0), device="cpu")
    batch = TokenPipeline(tc, 2, 8, seed=0).batch_at(0)
    assert torch.equal(model.loss(tc, params, batch, rules)[0],
                       model.loss(tc, params, batch)[0])
    got = model.prefill(tc, params, batch, 12, rules)
    want = model.prefill(tc, params, batch, 12)
    assert torch.equal(got[1], want[1])
    nxt = torch.argmax(want[1], -1)
    assert torch.equal(model.decode_step(tc, params, got[0], nxt, rules)[1],
                       model.decode_step(tc, params, want[0], nxt)[1])
    # the dry-run's sharded stand-ins wait for A13g
    for fn in (lambda: model.structs(tc, rules), model.cache_structs,
               input_specs):
        with pytest.raises(NotImplementedError, match="ROADMAP A13g"):
            fn()
    with pytest.raises(NotImplementedError, match="ROADMAP A13f"):
        get_model(tcfg.get_smoke_config("seamless-m4t-large-v2"))
    with pytest.raises(NotImplementedError, match="ROADMAP A13d"):
        tcfg.get_smoke_config("zamba2-7b").n_params()
    with pytest.raises(ValueError, match="MoE"):
        T.collect_moe_routing(tc, None, np.zeros((1, 4), np.int32))


@pytest.mark.parametrize("knob,value", [
    ("remat", "none"), ("microbatch", 2),
    ("router_aux_weight", 0.0), ("scan_layers", False), ("fsdp", True),
    ("hier_allreduce", True), ("moe_impl", "gspmd")])
def test_unported_knobs_are_rejected_naming_their_roadmap_item(knob, value):
    """No knob is left unported: the training knobs are read since A13b,
    the mesh knobs since A13c (``fsdp`` and ``moe_impl`` by the model on
    a mesh; ``hier_allreduce`` by nothing, in either package), so the
    entry points take every one."""
    tc = tcfg.get_smoke_config("granite-moe-3b-a800m")
    get_model(tc)
    bad = dataclasses.replace(tc, **{knob: value})
    assert not hasattr(base_config, "UNPORTED_KNOBS")
    get_model(bad)
    T.collect_moe_routing(bad, get_model(bad).init(
        bad, torch.Generator().manual_seed(0), device="cpu"),
        np.zeros((1, 4), np.int32))


def test_use_pallas_is_accepted_and_reaches_the_rmsnorm_op(monkeypatch):
    """``use_pallas=True`` is a ported knob: the entry points take it, and
    every RMSNorm of the layers goes through ``kernels.ops.rmsnorm`` (its
    plain version on the CPU, so the fp32 routes do not change)."""
    from repro_torch.kernels import ops
    tc = dataclasses.replace(tcfg.get_smoke_config("granite-moe-3b-a800m"),
                             dtype="float32")
    on = dataclasses.replace(tc, use_pallas=True)
    get_model(on)
    params = get_model(tc).init(tc, torch.Generator().manual_seed(0),
                                device="cpu")
    toks = TokenPipeline(tc, 2, 16, seed=0).batch_at(0)["tokens"]
    want = T.collect_moe_routing(tc, params, toks)
    calls = []
    real = ops.rmsnorm

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "rmsnorm", counted)
    assert not calls and T.collect_moe_routing(tc, params, toks).size
    assert not calls
    np.testing.assert_array_equal(T.collect_moe_routing(on, params, toks),
                                  want)
    assert len(calls) == 2 * tc.n_layers


# ---------------------------------------------------------------------------
# the routing slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["einsum", "blocked", "pallas"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_fp32_routes_context_and_clusters_identical(arch, impl):
    """``blocked`` runs q blocks of 24 (with a ragged tail); ``pallas`` is
    the JAX kernel in interpret mode against the port's plain version."""
    jc, tc = _configs(arch, "float32", attn_impl=impl,
                      q_block=24 if impl == "blocked" else 2048)
    jp, tp = _weights(jc)
    toks = _tokens(jc)
    want = JT.collect_moe_routing(jc, jp, jnp.asarray(toks))
    got = T.collect_moe_routing(tc, tp, toks)
    assert got.dtype == np.int32 and got.shape == want.shape == (
        jc.n_layers, B, S, jc.top_k)
    np.testing.assert_array_equal(got, want)
    jctx = JT.routing_context(jc, toks, want)
    tctx = T.routing_context(tc, toks, got)
    assert tctx.sizes == jctx.sizes
    np.testing.assert_array_equal(tctx.tuples, jctx.tuples)
    jres = JaxBatchMiner(jctx.sizes, theta=0.2)(jctx.tuples)
    tres = BatchMiner(tctx.sizes, theta=0.2, device="cpu")(tctx.tuples)
    assert_results_identical(jres, tres)


def _jax_routing_layer(cfg, p, x, positions):
    """One layer of ``repro.models.telemetry.collect_moe_routing``, with
    its router logits."""
    h = JC.rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    x = x + JC.attention(cfg, p["attn"], h, positions, impl=cfg.attn_impl,
                         q_block=cfg.q_block)
    h = JC.rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    logits = jnp.einsum("bsd,de->bse", h, p["moe"]["router"].astype(h.dtype))
    y, _ = JC.moe_ffn(cfg, p["moe"], h)
    return x + y, logits.astype(jnp.float32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_bf16_router_logits_within_tolerance(arch):
    """Layer by layer from the JAX package's own layer input, the port's
    router logits are within the bf16 tolerance; end to end, most routes
    agree (a one-ulp difference may flip a top-k choice)."""
    jc, tc = _configs(arch, "bfloat16")
    jp, tp = _weights(jc)
    toks = _tokens(jc)
    pos = np.arange(S, dtype=np.int32)
    x = jp["embed"].astype(jnp.bfloat16)[jnp.asarray(toks)]
    for i in range(jc.n_layers):
        pj = jax.tree.map(lambda a: a[i], jp["layers"])
        x_next, want = _jax_routing_layer(jc, pj, x, jnp.asarray(pos))
        _, got, _ = T.routing_layer(tc, layer_slice(tp["layers"], i),
                                    _t(x, torch.bfloat16),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL["bfloat16"])
        x = x_next
    want = JT.collect_moe_routing(jc, jp, jnp.asarray(toks))
    got = T.collect_moe_routing(tc, tp, toks)
    assert float((got == want).mean()) > 0.9


def test_routing_launch_twin_runs_on_the_cpu(capsys):
    rc = mine_moe_routing.main(["--device", "cpu", "--attn-impl", "pallas",
                                "--arch", "granite-moe-3b-a800m"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "routing context: vocab=256 experts=8 layers=2" in out
    assert "routing triclusters" in out and "top co-activation" in out


def test_routing_context_matches_on_random_routes():
    jc, tc = _configs("granite-moe-3b-a800m")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab_size, (3, 50)).astype(np.int32)
    routes = rng.integers(0, jc.n_experts, (5, 3, 50, jc.top_k)
                          ).astype(np.int32)
    jctx = JT.routing_context(jc, toks, routes)
    tctx = T.routing_context(tc, toks, routes)
    assert tctx.sizes == jctx.sizes == (jc.vocab_size, jc.n_experts, 5)
    assert tctx.tuples.dtype == jctx.tuples.dtype
    np.testing.assert_array_equal(tctx.tuples, jctx.tuples)
