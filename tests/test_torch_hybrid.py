"""Parity of the port's hybrid family (Zamba2: ``models.lm`` over
``models.ssm``) with the JAX package on the CPU, on ``zamba2-smoke`` (7
layers: 2 groups of 3 Mamba2 layers, each ending with the shared
attention+MLP block, and a tail of 1) in float32 with the same weights
(the JAX tree converted by ``from_jax_params``) and tokens.

Logits are held to the JAX package's and to an exact evaluation: the
same model in float64 with numpy (``tests/_hybrid_exact.py``: the Mamba2
layers as their sequential recurrence, independent of both packages),
over the prompt and the 8 tokens fed.  The smoke weights amplify float32
rounding: the JAX package's float32 logits lie up to 2.58e-5 of the
row's max from the exact ones (the forward's worst row), so no float32
evaluation that sums in another order can be held to 2e-5 of them
everywhere; the port's lie up to 5.49e-5.  The limit is
``min(1e-4, max(2e-5, 3 E))``, E the JAX package's worst distance from
the exact logits over every compared row (a reading of the JAX package
alone), for the port against the JAX package and against the exact
logits.  The cache leaves get the serving tests' model tolerance (2e-4), positions
exactly, greedy tokens token for token.  The train step's parity is
``tests/test_torch_train.py``'s (zamba2-7b is one of its archs), the
(1, 1) mesh's ``tests/test_torch_sharding.py``'s and the 4-rank mesh's
``tests/_torch_mesh_check.py``'s."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import lm as JL
from repro.models.api import get_model as jax_get_model
from repro.models.params import count_params
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.train.checkpoints import CheckpointManager as JaxManager
from repro.train.step import init_train_state as jax_init_train_state

from repro_torch import configs as tcfg
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import lm as L
from repro_torch.models.api import get_model
from repro_torch.models.params import (from_jax_params, layer_slice,
                                       layer_views, tree_items)
from repro_torch.serve import ServeEngine
from repro_torch.train.checkpoints import CheckpointManager
from repro_torch.train.step import from_jax_state

from _hybrid_exact import logits as exact_logits

ARCH = "zamba2-7b"
B, S, MAX_LEN, STEPS = 2, 32, 48, 8
ROW_TOL, ROW_CAP = 2e-5, 1e-4
NAMES = ("forward", "prefill") + tuple(f"decode {i}" for i in range(STEPS))
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _configs(**kw):
    return (dataclasses.replace(jcfg.get_smoke_config(ARCH),
                                dtype="float32", **kw),
            dataclasses.replace(tcfg.get_smoke_config(ARCH),
                                dtype="float32", **kw))


@functools.lru_cache(None)
def _weights():
    jc, _ = _configs()
    jp = jax_get_model(jc).init(jc, jax.random.PRNGKey(0))
    return jp, from_jax_params(jp, device="cpu")


def _tokens():
    return np.random.default_rng(0).integers(1, 255, (B, S)).astype(np.int32)


def _row_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float((np.abs(got - want).max(-1)
                  / np.abs(want).max(-1)).max())


@pytest.fixture(scope="module")
def served():
    """The JAX package's forward, prefill and 8 greedy decode steps, the
    port's (fed the JAX tokens), and the exact logits of each: one float64
    evaluation over the prompt and the tokens fed."""
    jc, tc = _configs()
    jp, tp = _weights()
    toks = _tokens()
    out = {"forward": [np.asarray(jax.jit(lambda p, t: JL.forward(
        jc, p, t))(jp, jnp.asarray(toks))[0]),
        L.forward(tc, tp, toks)[0].numpy()]}
    jcache, jl = jax.jit(lambda p, t: JL.prefill(jc, p, t, MAX_LEN))(
        jp, jnp.asarray(toks))
    cache, tl = L.prefill(tc, tp, toks, MAX_LEN)
    out["prefill"] = [np.asarray(jl), tl.numpy()]
    # (decode_step writes the port's cache in place)
    out["caches"] = [(jax.device_get(jcache),
                      {k: v.clone() for k, v in cache.items()})]
    step = jax.jit(lambda p, c, t: JL.decode_step(jc, p, c, t))
    fed = []
    for i in range(STEPS):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        fed.append((nxt, tl.argmax(-1).numpy()))
        jcache, jl = step(jp, jcache, jnp.asarray(nxt))
        cache, tl = L.decode_step(tc, tp, cache, torch.from_numpy(nxt))
        out[f"decode {i}"] = [np.asarray(jl), tl.numpy()]
    out["caches"].append((jax.device_get(jcache), cache))
    out["fed"] = fed
    exact = exact_logits(jc, jp, np.concatenate(
        [toks] + [want[:, None] for want, _ in fed], 1))
    out["forward"].append(exact[:, :S])
    out["prefill"].append(exact[:, S - 1])
    for i in range(STEPS):
        out[f"decode {i}"].append(exact[:, S + i])
    return out


def _limit(served) -> float:
    """``min(1e-4, max(2e-5, 3 E))``: E the JAX package's worst distance
    from the exact logits over every compared row."""
    worst = max(_row_err(served[k][0], served[k][2]) for k in NAMES)
    return min(ROW_CAP, max(ROW_TOL, 3 * worst))


def _check(name, served):
    want, got, exact = served[name]
    limit = _limit(served)
    err, err64 = _row_err(got, want), _row_err(got, exact)
    assert np.isfinite(got).all() and max(err, err64) <= limit, (
        f"{name}: {err:.3e} of the row's max from the JAX package, "
        f"{err64:.3e} from the exact logits (limit {limit:.3e}; the JAX "
        f"package from the exact logits {_row_err(want, exact):.3e})")


def test_params_tree_and_counts_match_jax():
    jc, tc = _configs()
    jdefs = jax_get_model(jc).param_defs(jc)
    tdefs = get_model(tc).param_defs(tc)
    jflat = jax.tree_util.tree_flatten_with_path(
        jdefs, is_leaf=lambda x: hasattr(x, "axes"))[0]
    tflat = [(tuple(k.key for k in p), d) for p, d in
             jax.tree_util.tree_flatten_with_path(
                 tdefs, is_leaf=lambda x: hasattr(x, "axes"))[0]]
    assert [(tuple(k.key for k in p), tuple(d.shape), tuple(d.axes),
             d.init, d.scale) for p, d in jflat] == \
        [(p, tuple(d.shape), tuple(d.axes), d.init, d.scale)
         for p, d in tflat]
    assert tc.n_params() == count_params(jdefs)
    assert tcfg.get_config(ARCH).n_params() == 6_751_130_832 == \
        count_params(jax_get_model(jcfg.get_config(ARCH)).param_defs(
            jcfg.get_config(ARCH)))
    jp, tp = _weights()
    items = tree_items(tp)
    assert [p for p, _ in items] == [
        tuple(k.key for k in p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    for (p, t), a in zip(items, jax.tree.leaves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a), err_msg=p)
    # the two-level stack: group g, layer i
    main = tp["layers"]["mamba_main"]
    assert main["wz"].shape == (2, 3, 64, 128)
    groups = layer_views(main, 2)
    for g in range(2):
        for i, view in enumerate(layer_views(groups[g], 3)):
            one = layer_slice(layer_slice(main, g), i)
            assert all(torch.equal(view[k], one[k]) for k in one)
            assert torch.equal(one["wx"], main["wx"][g, i])
    drawn = get_model(tc).init(tc, torch.Generator().manual_seed(0),
                               device="cpu")
    assert [(p, tuple(x.shape)) for p, x in tree_items(drawn)] == \
        [(p, tuple(x.shape)) for p, x in items]


@pytest.mark.parametrize("batch,max_len", [(3, 50), (1, 20)])
def test_cache_defs_and_init_cache_match_the_jax_package(batch, max_len):
    jc, tc = _configs()
    jd = JL.cache_defs(jc, batch, max_len, jnp.bfloat16)
    td = L.cache_defs(tc, batch, max_len, torch.bfloat16)
    assert sorted(td) == sorted(jd)
    for k in jd:
        assert td[k].shape == jd[k].shape and td[k].axes == jd[k].axes, k
        assert td[k].fill == jd[k].fill, k
        assert str(td[k].dtype)[6:] == str(np.dtype(jd[k].dtype)), k
    cache = L.init_cache(tc, batch, max_len, device="cpu")
    jcache = JL.init_cache(jc, batch, max_len)
    for k, v in jcache.items():
        np.testing.assert_array_equal(cache[k].float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)


def test_forward_matches_jax(served):
    _check("forward", served)


def test_prefill_logits_and_cache_match_jax(served):
    _check("prefill", served)
    jcache, cache = served["caches"][0]
    assert sorted(cache) == sorted(jcache)
    for k, v in jcache.items():
        want = np.asarray(v)
        got = cache[k].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **MODEL_TOL)
    assert int(cache["pos"]) == S


def test_decode_steps_match_jax(served):
    """8 greedy steps: the port fed the JAX package's tokens, which its
    own argmax equals at every step."""
    for i in range(STEPS):
        _check(f"decode {i}", served)
    for want, got in served["fed"]:
        np.testing.assert_array_equal(got, want)
    jcache, cache = served["caches"][1]
    for k, v in jcache.items():
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(v),
                                   err_msg=k, **MODEL_TOL)
    assert int(cache["pos"]) == S + STEPS


def test_serve_engine_matches_the_jax_engine():
    """Ragged prompts of 34, 33, 32 and 34 tokens: the prefill runs over
    the shortest (two whole chunks), the replay feeds the rest."""
    jc, tc = _configs()
    jp, tp = _weights()
    prompts = TokenPipeline(tc, 4, 34, seed=3).prompts(4, 34)
    assert [len(p) for p in prompts] == [34, 33, 32, 34]
    want = JaxServeEngine(jc, jp, max_len=64).generate(prompts, 6)
    got = ServeEngine(tc, tp, max_len=64).generate(prompts, 6)
    assert got.tokens == want.tokens and got.steps == want.steps


def test_train_state_checkpoints_cross_both_packages(tmp_path):
    """A JAX hybrid train state (the two-level stacks, the shared block)
    and the port's copy of it write the same bytes, and each package
    restores the other's checkpoint."""
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
    assert "params__layers__mamba_main__conv_w.npy" in names
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


def test_launchers_serve_and_train_the_smoke_config(capsys, tmp_path):
    assert serve_mod.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--new-tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "arch=zamba2-smoke" in out and out.count("sample[") == 2
    assert train_mod.main(["--arch", ARCH, "--smoke", "--steps", "2",
                           "--global-batch", "2", "--seq", "32",
                           "--log-every", "1", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("[train] step") == 2 and "[train] done" in out


def test_a_pattern_without_a_group_is_refused_by_prefill():
    """``n_layers < attn_every`` (2 layers at ``attn_every`` 3: no shared
    block, a tail of 2 Mamba2 layers) has no KV ring: the port's prefill
    refuses it with a ``ValueError`` naming the pattern, where the JAX
    package's fails on an empty stack.  The forward runs in both."""
    jc, tc = _configs(n_layers=2)
    jp = jax_get_model(jc).init(jc, jax.random.PRNGKey(0))
    tp = from_jax_params(jp, device="cpu")
    toks = _tokens()[:, :16]
    want = np.asarray(JL.forward(jc, jp, jnp.asarray(toks))[0])
    assert _row_err(L.forward(tc, tp, toks)[0].numpy(), want) <= ROW_CAP
    with pytest.raises(ValueError, match="n_layers=2, attn_every=3 has no "
                       "group"):
        L.prefill(tc, tp, toks, MAX_LEN)
    with pytest.raises(IndexError):
        JL.prefill(jc, jp, jnp.asarray(toks), MAX_LEN)


@pytest.mark.parametrize("s", [1, 2])
def test_a_prompt_shorter_than_the_conv_window_never_decodes(s):
    """A prefill of fewer than ``conv_width - 1`` tokens gives its logits
    (the JAX package's), but no decode step follows it: the port refuses
    with a ``ValueError`` where the JAX package's step fails in its
    depthwise conv on the short window it kept.  The port's cache keeps
    its leaves' shapes and carries the short length as one more entry,
    so a copy of the cache refuses too."""
    jc, tc = _configs()
    jp, tp = _weights()
    assert tc.conv_width - 1 == 3
    toks = _tokens()[:, :s]
    jcache, jl = JL.prefill(jc, jp, jnp.asarray(toks), MAX_LEN)
    cache, tl = L.prefill(tc, tp, toks, MAX_LEN)
    assert _row_err(tl.numpy(), np.asarray(jl)) <= ROW_CAP
    fresh = L.init_cache(tc, B, MAX_LEN, torch.float32, device="cpu")
    assert int(cache.pop(L.SHORT_PREFILL)) == s
    assert {k: v.shape for k, v in cache.items()} == {
        k: v.shape for k, v in fresh.items()}
    cache[L.SHORT_PREFILL] = torch.tensor(s)
    nxt = toks[:, 0]
    for c in (cache, {k: v.clone() for k, v in cache.items()}):
        with pytest.raises(ValueError, match=f"prefill took {s} tokens, "
                           "fewer than conv_width - 1 = 3"):
            L.decode_step(tc, tp, c, torch.from_numpy(nxt))
    assert int(cache["pos"]) == s
    with pytest.raises(ValueError, match="label 'w'"):
        JL.decode_step(jc, jp, jcache, jnp.asarray(nxt))


def test_serve_engine_refuses_a_ragged_batch_with_a_short_prompt():
    """Prompts of 2 and 5 tokens: both engines prefill at the shortest, 2,
    and both refuse the replay's first decode step (a ``ValueError``)."""
    jc, tc = _configs()
    jp, tp = _weights()
    prompts = [[7, 9], [3, 4, 5, 6, 8]]
    with pytest.raises(ValueError, match="label 'w'"):
        JaxServeEngine(jc, jp, max_len=16).generate(prompts, 4)
    with pytest.raises(ValueError, match="prefill took 2 tokens"):
        ServeEngine(tc, tp, max_len=16).generate(prompts, 4)


def test_a_prompt_of_conv_width_minus_one_tokens_decodes():
    """At ``conv_width - 1`` = 3 tokens the window is whole: the prefill
    and a decode step give the logits of the port's own forward over the 4
    tokens, within 1e-5 of the row's max."""
    _, tc = _configs()
    _, tp = _weights()
    toks = _tokens()[:, :4]
    full = L.forward(tc, tp, toks)[0].numpy()
    cache, tl = L.prefill(tc, tp, toks[:, :3], MAX_LEN)
    assert L.SHORT_PREFILL not in cache
    _, dl = L.decode_step(tc, tp, cache, torch.from_numpy(toks[:, 3]))
    assert _row_err(tl.numpy(), full[:, 2]) <= 1e-5
    assert _row_err(dl.numpy(), full[:, 3]) <= 1e-5
