"""Parity of the port's training slice with the JAX package on the CPU:
``lm.loss_fn``, ``train.optim`` and ``train.step``.

Both packages start from the same state (the JAX ``init_train_state``,
carried over by ``from_jax_state``) and take the same ``TokenPipeline``
batches; the JAX side runs ``jit_train_step`` on a one-device mesh with
``MeshRules``, as ``tests/test_arch_smoke.py`` does.  Three steps with
``warmup_steps=1``: step 0 has lr 0, so the parameters move on steps 1
and 2.  Tolerances:

* float32: loss, nll, aux and grad norm within rtol 1e-4; every leaf of
  ``params``, ``opt.m`` and ``opt.v`` after the last step within 2e-4 of
  the leaf's largest magnitude (the repo's model-parity tolerance,
  ``tests/test_models_parity.py``, on the leaf's scale: the two packages
  sum gradients in other orders, and ``v`` squares them);
* ``grad_compress``: the gradients are rounded to bfloat16, and two
  float32 values a rounding apart can land one bf16 ulp apart, so the
  moments get 2**-8 of the leaf's largest magnitude;
* bfloat16 compute: the loss within the JAX kernel tests' 2e-2
  (``tests/test_kernels.py:17``; bf16 gradients are too noisy to compare
  elementwise);
* ``lr`` within one float32 ulp plus one ulp of the cosine carried
  through its coefficient 0.45·peak (:func:`_lr_close`: XLA's ``cos`` and
  torch's may differ by one ulp, and ``1 + cos`` cancels); ``opt.step``
  and ``data_step`` equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data.tokens import TokenPipeline
from repro.launch.mesh import make_mesh
from repro.models import lm as JL
from repro.models.api import get_model as jax_get_model
from repro.sharding.rules import MeshRules
from repro.train import optim as JO
from repro.train import step as JS

from repro_torch import configs as tcfg
from repro_torch.models import lm as L
from repro_torch.models.api import get_model
from repro_torch.data.tokens import TokenPipeline as TTokenPipeline
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import from_jax_params, tree_items
from repro_torch.sharding import MeshRules as TMeshRules
from repro_torch.sharding import PartitionSpec as TPartitionSpec
from repro_torch.train import optim as TO
from repro_torch.train import step as TS

ARCHS = ["qwen3-0.6b", "granite-moe-3b-a800m", "internvl2-76b"]
B, S, STEPS = 2, 16, 3
TC = dict(total_steps=10, warmup_steps=1)
SCALAR_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
LEAF_TOL = 2e-4


def _configs(arch, dtype, **kw):
    return (dataclasses.replace(jcfg.get_smoke_config(arch), dtype=dtype,
                                **kw),
            dataclasses.replace(tcfg.get_smoke_config(arch), dtype=dtype,
                                **kw))


@functools.lru_cache(None)
def _jax_run(arch, dtype, batch, cfg_kw=(), tc_kw=()):
    """(initial state, per-step metrics, final state) of the JAX step, as
    numpy."""
    jc, _ = _configs(arch, dtype, **dict(cfg_kw))
    mesh = make_mesh((1, 1), ("data", "model"))
    pipe = TokenPipeline(jc, batch, S, seed=0)
    with mesh:
        state = JS.init_train_state(jc, jax.random.PRNGKey(1))
        init = jax.device_get(state)
        step = JS.jit_train_step(jc, MeshRules(mesh),
                                 JS.TrainConfig(**TC, **dict(tc_kw)))
        rows = []
        for i in range(STEPS):
            state, m = step(state, {k: jnp.asarray(v) for k, v in
                                    pipe.batch_at(i).items()})
            rows.append({k: np.asarray(v) for k, v in m.items()})
    return init, rows, jax.device_get(state)


def _port_run(arch, dtype, batch, init, cfg_kw=(), tc_kw=()):
    _, tc = _configs(arch, dtype, **dict(cfg_kw))
    pipe = TokenPipeline(tc, batch, S, seed=0)
    state = TS.from_jax_state(init, device="cpu")
    step = TS.make_train_step(tc, None, TS.TrainConfig(**TC, **dict(tc_kw)))
    rows = []
    for i in range(STEPS):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                pipe.batch_at(i).items()})
        rows.append({k: v.numpy() for k, v in m.items()})
    return rows, state


def _lr_close(got, want, peak: float) -> bool:
    """Float32 learning rates equal but for one ulp of their own and one
    ulp of the cosine (at most 1 in magnitude) times its coefficient
    ``(1 - floor_frac) * 0.5 * peak``."""
    got, want = np.float32(got), np.float32(want)
    tol = np.spacing(np.abs(want)) + 0.45 * peak * np.spacing(np.float32(1))
    return bool(np.all(np.abs(got - want) <= tol))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _check_run(want_rows, got_rows, want, got, dtype, moment_tol=LEAF_TOL):
    rtol = SCALAR_RTOL[dtype]
    for i, (w, g) in enumerate(zip(want_rows, got_rows)):
        assert set(g) == set(w), (set(g), set(w))
        keys = ("loss", "nll", "aux") + (
            ("grad_norm",) if dtype == "float32" else ())
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        assert _lr_close(g["lr"], w["lr"], JS.TrainConfig().peak_lr), (
            i, g["lr"], w["lr"])
        assert np.isfinite(g["grad_norm"])
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == STEPS
    assert int(got["data_step"]) == int(want["data_step"]) == STEPS
    if dtype != "float32":
        return
    for part, w_tree, g_tree, tol in (
            ("params", want["params"], got["params"], LEAF_TOL),
            ("m", want["opt"]["m"], got["opt"]["m"], moment_tol),
            ("v", want["opt"]["v"], got["opt"]["v"], moment_tol)):
        g_items = tree_items(g_tree)
        assert len(g_items) == len(jax.tree.leaves(w_tree))
        for path, leaf in g_items:
            w = _leaf(w_tree, path)
            g = leaf.detach().numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, path
            np.testing.assert_allclose(
                g, w, rtol=0, atol=tol * float(np.abs(w).max()),
                err_msg=f"{part}/{'/'.join(path)}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, dtype):
    """Dense with qk-norm (qwen3), MoE with its aux loss (granite-moe) and
    the patch frontend (internvl2): three steps against
    ``jit_train_step``."""
    init, want_rows, want = _jax_run(arch, dtype, B)
    got_rows, got = _port_run(arch, dtype, B, init)
    _check_run(want_rows, got_rows, want, got, dtype)


@pytest.mark.parametrize("case,cfg_kw,tc_kw,moment_tol", [
    ("microbatch", (("microbatch", 2),), (), LEAF_TOL),
    ("grad_compress", (), (("grad_compress", True),), 2.0 ** -8),
    ("no_clip", (), (("grad_clip", None),), LEAF_TOL)])
def test_train_step_options_match_jax(case, cfg_kw, tc_kw, moment_tol):
    """Gradient accumulation over two microbatches (the last one's
    metrics), bf16-rounded gradients, and no clip (grad norm 0)."""
    init, want_rows, want = _jax_run("qwen3-0.6b", "float32", 2 * B,
                                     cfg_kw, tc_kw)
    got_rows, got = _port_run("qwen3-0.6b", "float32", 2 * B, init, cfg_kw,
                              tc_kw)
    _check_run(want_rows, got_rows, want, got, "float32", moment_tol)
    if case == "no_clip":
        assert all(float(r["grad_norm"]) == 0.0 for r in got_rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_block_and_none_are_bit_identical(dtype):
    """Recomputing each block in the backward gives the same numbers as
    keeping its activations."""
    base = dataclasses.replace(tcfg.get_smoke_config("granite-moe-3b-a800m"),
                               dtype=dtype)
    assert base.remat == "block"
    pipe = TokenPipeline(base, B, S, seed=0)
    out = {}
    for remat in ("block", "none"):
        cfg = dataclasses.replace(base, remat=remat)
        state = TS.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        step = TS.make_train_step(cfg, None, TS.TrainConfig(**TC))
        rows = []
        for i in range(STEPS):
            state, m = step(state, {k: torch.from_numpy(v) for k, v in
                                    pipe.batch_at(i).items()})
            rows.append(m)
        out[remat] = rows, state
    (ra, sa), (rb, sb) = out["block"], out["none"]
    for a, b in zip(ra, rb):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for part in ("params", ("opt", "m"), ("opt", "v")):
        ta = sa[part] if isinstance(part, str) else sa[part[0]][part[1]]
        tb = sb[part] if isinstance(part, str) else sb[part[0]][part[1]]
        for (path, x), (_, y) in zip(tree_items(ta), tree_items(tb)):
            assert torch.equal(x, y), (part, path)


def test_loss_fn_matches_jax_and_ignores_masked_labels():
    """The loss alone, fp32, with labels masked (-100) in the middle of
    the sequence and a row with no valid label."""
    jc, tc = _configs("granite-moe-3b-a800m", "float32")
    jp = jax.device_get(jax_get_model(jc).init(jc, jax.random.PRNGKey(3)))
    tp = from_jax_params(jp, device="cpu", requires_grad=True)
    batch = TokenPipeline(jc, B, S, seed=5).batch_at(0)
    batch["labels"][0, 3:9] = -100
    batch["labels"][1] = -100
    wl, wm = jax.jit(lambda p, b: JL.loss_fn(jc, p, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    gl, gm = L.loss_fn(tc, tp, batch)
    np.testing.assert_allclose(gl.item(), float(wl), rtol=1e-5)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(gm[k].item(), float(wm[k]), rtol=1e-5)
    with torch.no_grad():
        assert torch.equal(get_model(tc).loss(tc, tp, batch)[0], gl.detach())


@pytest.mark.parametrize("grad_clip", [1.0, 0.05, None])
def test_adamw_update_and_cosine_lr_match_jax(grad_clip):
    """One optimizer update of a random tree (two steps in, so the bias
    corrections are not 1 - b), and the schedule over warmup, decay and
    the floor."""
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal(11).astype(np.float32)}}
    grads = {"a": rng.standard_normal((5, 7)).astype(np.float32),
             "b": {"c": rng.standard_normal(11).astype(np.float32) * 3}}
    m = jax.tree.map(lambda x: np.abs(x) * 0.1, grads)
    v = jax.tree.map(lambda x: x * x * 0.01, grads)
    lr = np.float32(3e-3)
    wp, wo, wn = JO.adamw_update(tree, grads, {"m": m, "v": v,
                                               "step": jnp.int32(2)},
                                 jnp.float32(lr), grad_clip=grad_clip)
    st = TS.from_jax_state({"params": tree, "opt": {"m": m, "v": v,
                                                    "step": 2},
                            "data_step": 0}, device="cpu")
    tg = TS.from_jax_state({"params": grads, "opt": {"m": m, "v": v,
                                                     "step": 0},
                            "data_step": 0}, device="cpu")["params"]
    gp, go, gn = TO.adamw_update(st["params"], tg, st["opt"],
                                 torch.tensor(lr), grad_clip=grad_clip)
    assert gp is st["params"] and int(go["step"]) == 3
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-6)
    for part, w_tree, g_tree in (("params", wp, gp), ("m", wo["m"], go["m"]),
                                 ("v", wo["v"], go["v"])):
        for path, leaf in tree_items(g_tree):
            np.testing.assert_allclose(leaf.detach().numpy(),
                                       _leaf(w_tree, path), rtol=2e-6,
                                       atol=1e-7, err_msg=f"{part} {path}")
    steps = np.arange(0, 130, dtype=np.int32)
    for warmup in (0, 1, 20):
        want = np.asarray(jax.vmap(lambda s: JO.cosine_lr(
            s, peak=3e-3, warmup=warmup, total=100))(jnp.asarray(steps)))
        got = TO.cosine_lr(torch.from_numpy(steps), peak=3e-3,
                           warmup=warmup, total=100).numpy()
        assert got.dtype == np.float32
        assert _lr_close(got, want, 3e-3), warmup


def test_training_refuses_what_it_cannot_train():
    """Kernel switches (no backward in either package) and the families
    of A13d-f raise before the first step, naming why; a mesh is taken
    (its layouts are the twins of the JAX package's), and only the
    dry-run's sharded stand-ins wait for A13g."""
    tc = tcfg.get_smoke_config("qwen3-0.6b")
    for bad in (dataclasses.replace(tc, attn_impl="pallas"),
                dataclasses.replace(tc, use_pallas=True)):
        with pytest.raises(NotImplementedError, match="no backward"):
            TS.make_train_step(bad)
    rules = TMeshRules(make_local_mesh(device="cpu"))
    assert callable(TS.make_train_step(tc, rules=rules))
    params = get_model(tc).init(tc, torch.Generator().manual_seed(0),
                                device="cpu")
    batch = TTokenPipeline(tc, 2, 8, seed=0).batch_at(0)
    assert torch.equal(L.loss_fn(tc, params, batch, rules=rules)[0],
                       L.loss_fn(tc, params, batch)[0])
    shard = TS.state_shardings(tc, rules)
    assert shard["params"]["embed"].spec == ("model", "data")   # ZeRO-1
    assert TO.zero1_shardings(get_model(tc).param_defs(tc), rules)[
        "embed"].spec == ("model", "data")
    assert TO.zero1_spec(TPartitionSpec(None, "model"), (6, 4), rules) \
        == ("data", "model")
    with pytest.raises(NotImplementedError, match="ROADMAP A13g"):
        TS.state_structs(tc, rules)
    for arch, item in (("zamba2-7b", "A13d"), ("xlstm-125m", "A13e"),
                       ("seamless-m4t-large-v2", "A13f")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            TS.make_train_step(tcfg.get_smoke_config(arch))
