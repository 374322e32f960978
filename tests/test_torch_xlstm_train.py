"""The port's xLSTM family (``xlstm-smoke``) beyond the forward, against
the JAX package on the CPU: three training steps against
``jit_train_step`` (``tests/test_torch_train.py``'s limits: float32
loss, nll and grad norm within rtol 1e-4, every leaf of the state within
2e-4 of its largest magnitude, a zero-initialised leaf's parameters
within 1e-3, and the elements of the sLSTM's ``b_i`` whose exact
gradient was zero at a step within 2 Σ lr; bfloat16 the loss within
2e-2), the float64 witness of those ``b_i`` elements, train-state
checkpoints that each package restores from the other, ``ServeEngine``'s
greedy tokens against the JAX engine's, and the launchers on the CPU."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.launch.mesh import make_mesh
from repro.models import lm as JL
from repro.models.api import get_model as jax_get_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train.checkpoints import CheckpointManager as JaxManager
from repro.sharding.rules import MeshRules
from repro.train import step as JS
from repro.train.step import init_train_state as jax_init_train_state

from repro_torch import configs as tcfg
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import lm as L
from repro_torch.models.params import from_jax_params, tree_items
from repro_torch.serve import ServeEngine
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.train.step import from_jax_state

from test_torch_train import B, S, STEPS, TC, _check_run, _port_run

ARCH = "xlstm-125m"


def _jax_states(dtype):
    """The JAX package's three steps (``test_torch_train._jax_run``), with
    every state kept: (initial state, per-step metrics, states)."""
    jc = dataclasses.replace(jcfg.get_smoke_config(ARCH), dtype=dtype)
    mesh = make_mesh((1, 1), ("data", "model"))
    pipe = JTokenPipeline(jc, B, S, seed=0)
    with mesh:
        state = JS.init_train_state(jc, jax.random.PRNGKey(1))
        states = [jax.device_get(state)]
        step = JS.jit_train_step(jc, MeshRules(mesh), JS.TrainConfig(**TC))
        rows = []
        for i in range(STEPS):
            state, m = step(state, {k: jax.numpy.asarray(v) for k, v in
                                    pipe.batch_at(i).items()})
            rows.append({k: np.asarray(v) for k, v in m.items()})
            states.append(jax.device_get(state))
    return states[0], rows, states


def _b_i_grad(params, batch, dtype) -> np.ndarray:
    """The loss's gradient of the sLSTM's ``b_i`` at ``params`` (a JAX
    tree) over ``batch``, in the port at ``dtype`` (float64: the exact
    reference)."""
    tc = dataclasses.replace(tcfg.get_smoke_config(ARCH), dtype=dtype)
    p = from_jax_params(params, device="cpu", dtype=getattr(torch, dtype),
                        requires_grad=True)
    L.loss_fn(tc, p, {k: torch.from_numpy(v) for k, v in batch.items()}
              )[0].backward()
    return p["layers"]["slstm"]["b_i"].grad.double().numpy()


def _exact_zeros(states) -> np.ndarray:
    """The elements of ``b_i`` whose exact (float64) gradient is zero (at
    most 1e-15 of the largest) at some step of the run."""
    pipe = TokenPipeline(tcfg.get_smoke_config(ARCH), B, S, seed=0)
    out = None
    for i, st in enumerate(states[:-1]):
        g = np.abs(_b_i_grad(st["params"], pipe.batch_at(i), "float64"))
        zero = g <= 1e-15 * g.max()
        out = zero if out is None else out | zero
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_match_jax(dtype):
    """Three steps against ``jit_train_step`` with ``_check_run``'s
    limits; the elements of ``b_i`` whose exact gradient was zero at a
    step are its noise elements (see
    :func:`test_b_i_gradient_is_rounding_noise_where_it_is_zero`)."""
    init, want_rows, states = _jax_states(dtype)
    got_rows, got = _port_run(ARCH, dtype, B, init)
    path = ("layers", "slstm", "b_i")
    noise = {path: _exact_zeros(states)}
    assert 0 < noise[path].mean() < 1
    _check_run(want_rows, got_rows, states[-1], got, dtype, init=init,
               noise=noise)


def test_b_i_gradient_is_rounding_noise_where_it_is_zero():
    """The sLSTM's ``b_i`` adds the same shift to the input gate at every
    step, which scales c and n alike, so h = o·c / max(n, 1e-6) does not
    depend on it wherever n >= 1e-6: its exact gradient is zero but where
    the clamp acts.  At the JAX init, in float64 (the port's float64
    evaluation) and in float32 from each package: where the float64
    gradient is 0 (at most 1e-15 of the largest) both float32 gradients
    are rounding noise, each within 2e-5 of the largest from float64 as
    everywhere else; AdamW turns that noise into updates of about lr
    times its sign, so ``_check_run`` holds those elements to 2 Σ lr."""
    jc = dataclasses.replace(jcfg.get_smoke_config(ARCH), dtype="float32")
    init = jax.device_get(JS.init_train_state(jc, jax.random.PRNGKey(1)))
    batch = TokenPipeline(tcfg.get_smoke_config(ARCH), B, S,
                          seed=0).batch_at(1)
    jg = jax.jit(jax.grad(lambda p, b: JL.loss_fn(jc, p, b)[0]))(
        init["params"], {k: jax.numpy.asarray(v) for k, v in batch.items()})
    exact = _b_i_grad(init["params"], batch, "float64")
    scale = float(np.abs(exact).max())
    zero = np.abs(exact) <= 1e-15 * scale
    assert zero.sum() >= 4
    jax32 = np.asarray(jg["layers"]["slstm"]["b_i"], np.float64)
    for g in (jax32, _b_i_grad(init["params"], batch, "float32")):
        assert np.abs(g - exact).max() <= 2e-5 * scale
        assert 0 < np.abs(g[zero]).max() <= 2e-5 * scale


def test_train_state_checkpoints_cross_both_packages(tmp_path):
    """A JAX xLSTM train state (the two-level mLSTM stack, the sLSTM
    stack) and the port's copy of it write the same bytes, and each
    package restores the other's checkpoint."""
    jstate = jax.device_get(jax_init_train_state(
        jcfg.get_smoke_config(ARCH), jax.random.PRNGKey(2)))
    tstate = from_jax_state(jstate, device="cpu")
    jmgr = JaxManager(str(tmp_path / "jax"))
    tmgr = CheckpointManager(str(tmp_path / "port"))
    jmgr.save(3, jstate, metadata={"arch": ARCH})
    tmgr.save(3, tstate, metadata={"arch": ARCH})
    jdir, tdir = jmgr._path(3), tmgr._path(3)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert "params__layers__slstm__r_gates.npy" in names
    for f in names:
        with open(f"{jdir}/{f}", "rb") as a, open(f"{tdir}/{f}", "rb") as b:
            assert a.read() == b.read(), f
    step, host = CheckpointManager(str(tmp_path / "jax")).restore(
        template=tstate)
    restored = from_jax_state(host, device="cpu")
    assert step == 3
    for (pa, a), (pb, b) in zip(tree_items(restored), tree_items(tstate)):
        assert pa == pb and torch.equal(a, b), pa
    step, back = JaxManager(str(tmp_path / "port")).restore(template=jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_serve_engine_matches_the_jax_engine():
    """Ragged prompts of 34, 33, 32 and 34 tokens: the prefill runs over
    the shortest, the replay feeds the rest through the recurrent
    states."""
    jc = dataclasses.replace(jcfg.get_smoke_config(ARCH), dtype="float32")
    tc = dataclasses.replace(tcfg.get_smoke_config(ARCH), dtype="float32")
    jp = jax_get_model(jc).init(jc, jax.random.PRNGKey(0))
    tp = from_jax_params(jp, device="cpu")
    prompts = TokenPipeline(tc, 4, 34, seed=3).prompts(4, 34)
    assert [len(p) for p in prompts] == [34, 33, 32, 34]
    want = JaxServeEngine(jc, jp, max_len=64).generate(prompts, 6)
    got = ServeEngine(tc, tp, max_len=64).generate(prompts, 6)
    assert got.tokens == want.tokens and got.steps == want.steps


def test_launchers_serve_and_train_the_smoke_config(capsys, tmp_path):
    assert serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--new-tokens", "4", "--use-pallas"]) == 0
    out = capsys.readouterr().out
    assert "arch=xlstm-smoke" in out and out.count("sample[") == 2
    assert "use_pallas True, on cpu" in out
    assert train_mod.main(["--arch", ARCH, "--smoke", "--steps", "2",
                           "--global-batch", "2", "--seq", "32",
                           "--log-every", "1", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("[train] step") == 2 and "[train] done" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
