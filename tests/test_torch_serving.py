"""Parity of the port's LM serving slice with the JAX package on the CPU:
the decode cache, ``prefill``, ring-cache ``decode_step``, the
``ServeEngine`` and the serving entry point.

Both packages compute in fp32 with the same weights (the JAX tree
converted by ``from_jax_params``) on the same tokens.  Caches and
attention outputs are held to the repo's model-parity tolerance
(``tests/test_models_parity.py``: 2e-4), positions exactly, greedy
generations token for token.  Logits get that tolerance too, with an
absolute floor of 2e-5 of the step's largest logit: the smoke weights
make logits of magnitude ~30, and the two packages' fp32 sums in other
orders differ by up to ~1e-5 of that magnitude in any logit, large or
small.
The kernels' switches (``attn_impl="pallas"``, ``use_pallas=True``) run
the kernels' plain versions here, on CPU tensors.  The mistral-nemo and
internvl2 smoke configs get one test of their own: a prefill and a decode
step against the JAX package's ``prefill`` and ``decode_step``
(internvl2 through its patch frontend), and internvl2's decode against
``forward`` with a ring that holds every position and with one a slot
short: the ring of the JAX test that fails at take-up (ROADMAP queue
C)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import common as JC
from repro.models import lm as JL
from repro.models.api import get_model as jax_get_model
from repro.serve.engine import ServeEngine as JaxServeEngine

from repro_torch import configs as tcfg
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import common as C
from repro_torch.models import lm as L
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.api import get_model
from repro_torch.models.params import from_jax_params, layer_slice
from repro_torch.serve import GenerationResult, ServeEngine
from repro_torch.sharding import MeshRules

MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["granite-moe-3b-a800m", "granite-3-8b", "qwen3-0.6b",
         "h2o-danube-1.8b", "mixtral-8x7b"]
WINDOWED = ["h2o-danube-1.8b", "mixtral-8x7b"]     # window 32
B, S, MAX_LEN, STEPS = 2, 40, 96, 40


def _configs(arch, **kw):
    jc = dataclasses.replace(jcfg.get_smoke_config(arch), dtype="float32",
                             **kw)
    tc = dataclasses.replace(tcfg.get_smoke_config(arch), dtype="float32",
                             **kw)
    return jc, tc


@functools.lru_cache(None)
def _weights(arch):
    jc, _ = _configs(arch)
    jp = jax_get_model(jc).init(jc, jax.random.PRNGKey(0))
    return jp, from_jax_params(jp, device="cpu")


def _prompt_tokens(seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(1, 255, (b, s)
                                                ).astype(np.int32)


def _torch_cache(jcache) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}


def _check_logits(got, jl):
    want = np.asarray(jl)
    atol = max(MODEL_TOL["atol"], 2e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=MODEL_TOL["rtol"],
                               atol=atol)


def _check_cache(cache, jcache):
    assert sorted(cache) == sorted(jcache)
    for k, v in jcache.items():
        want = np.asarray(v)
        got = cache[k].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if want.dtype.kind == "i":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **MODEL_TOL)


# ---------------------------------------------------------------------------
# the decode cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,batch,max_len", [
    ("granite-moe-3b-a800m", 3, 50), ("h2o-danube-1.8b", 1, 50),
    ("mixtral-8x7b", 2, 20)])
def test_cache_defs_and_init_cache_match_the_jax_package(arch, batch,
                                                         max_len):
    jc, tc = _configs(arch)
    jd = JL.cache_defs(jc, batch, max_len, jnp.bfloat16)
    td = L.cache_defs(tc, batch, max_len, torch.bfloat16)
    assert sorted(td) == sorted(jd)
    assert L.cache_len(tc, max_len) == JL.cache_len(jc, max_len)
    jcache = JL.init_cache(jc, batch, max_len, jnp.float32)
    cache = get_model(tc).init_cache(tc, batch, max_len, torch.float32,
                                     device="cpu")
    for k in jd:
        assert td[k].shape == jd[k].shape and td[k].axes == jd[k].axes
        assert td[k].fill == jd[k].fill
    _check_cache(cache, jcache)
    assert cache["k"].dtype == torch.float32
    assert L.init_cache(tc, 1, 8, device="cpu")["v"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# prefill and decode against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_logits_match(arch):
    """Windowed configs (window 32 < 40 prompt tokens) wrap their ring in
    the prefill itself."""
    jc, tc = _configs(arch)
    jp, tp = _weights(arch)
    toks = _prompt_tokens()
    jcache, jl = JL.prefill(jc, jp, jnp.asarray(toks), MAX_LEN)
    cache, logits = get_model(tc).prefill(tc, tp, {"tokens": toks},
                                          MAX_LEN)
    assert logits.shape == (B, tc.vocab_size)
    _check_logits(logits, jl)
    _check_cache(cache, jcache)
    assert int(cache["pos"]) == S
    sc = L.cache_len(tc, MAX_LEN)
    assert cache["k"].shape == (tc.n_layers, B, sc, tc.n_kv_heads,
                                tc.head_dim)
    if arch in WINDOWED:
        assert sorted(cache["slot_pos"].tolist()) == list(range(S - sc, S))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_over_wrapping_rings(arch):
    """Every step starts both packages from the JAX cache (converted to
    torch) and compares the logits and every cache leaf; the windowed
    rings (32 slots) wrap more than once over the 40 steps."""
    jc, tc = _configs(arch)
    jp, tp = _weights(arch)
    jcache, _ = JL.prefill(jc, jp, jnp.asarray(_prompt_tokens()), MAX_LEN)
    step = jax.jit(functools.partial(JL.decode_step, jc))
    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        toks = rng.integers(1, 255, B).astype(np.int32)
        cache, logits = L.decode_step(tc, tp, _torch_cache(jcache), toks)
        jcache, jl = step(jp, jcache, jnp.asarray(toks))
        _check_logits(logits, jl)
        _check_cache(cache, jcache)
    assert int(cache["pos"]) == S + STEPS


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "internvl2-76b"])
def test_prefill_and_a_decode_step_match_at_the_larger_smoke_configs(arch):
    """fp32 prefill and one decode step of the two smoke configs that
    :data:`ARCHS` leaves out, against the JAX package's ``prefill`` and
    ``decode_step``; internvl2 prefills its patch embeddings first."""
    jc, tc = _configs(arch)
    jp, tp = _weights(arch)
    toks = _prompt_tokens(4)
    inputs, jpatches, n_front = {"tokens": toks}, None, 0
    if jc.frontend == "patch":
        n_front = jc.frontend_len
        patches = np.random.default_rng(5).standard_normal(
            (B, n_front, jc.frontend_dim)).astype(np.float32)
        inputs["patches"], jpatches = patches, jnp.asarray(patches)
    jcache, jl = JL.prefill(jc, jp, jnp.asarray(toks), MAX_LEN,
                            patches=jpatches)
    cache, logits = get_model(tc).prefill(tc, tp, inputs, MAX_LEN)
    _check_logits(logits, jl)
    _check_cache(cache, jcache)
    assert int(cache["pos"]) == S + n_front
    step_toks = np.random.default_rng(6).integers(1, 255, B).astype(np.int32)
    cache, logits = L.decode_step(tc, tp, cache, step_toks)
    jcache, jl = JL.decode_step(jc, jp, jcache, jnp.asarray(step_toks))
    _check_logits(logits, jl)
    _check_cache(cache, jcache)
    assert int(cache["pos"]) == S + n_front + 1


def test_head_dim_256_forward_prefill_and_decode_match():
    """granite-moe's smoke config at ``head_dim=256`` (Gemma-2-9B's head
    dim; the config's own field, which both packages take): the forward,
    the prefill and 2 decode steps in fp32 against the JAX package's, the
    port with the kernels' switches on (their plain versions here, at D
    256): logits and cache leaves within the file's tolerance, integer
    leaves equal."""
    arch = "granite-moe-3b-a800m"
    jc, tc = _configs(arch, head_dim=256)
    tc = dataclasses.replace(tc, attn_impl="pallas", use_pallas=True)
    assert tc.head_dim == 256 and tc.n_heads * 256 != tc.d_model
    jp = jax_get_model(jc).init(jc, jax.random.PRNGKey(0))
    tp = from_jax_params(jp, device="cpu")
    toks = _prompt_tokens(7)
    _check_logits(L.forward(tc, tp, toks)[0],
                  JL.forward(jc, jp, jnp.asarray(toks))[0])
    jcache, jl = JL.prefill(jc, jp, jnp.asarray(toks), MAX_LEN)
    cache, logits = L.prefill(tc, tp, toks, MAX_LEN)
    _check_logits(logits, jl)
    _check_cache(cache, jcache)
    assert cache["k"].shape[-1] == 256
    rng = np.random.default_rng(8)
    for _ in range(2):
        step_toks = rng.integers(1, 255, B).astype(np.int32)
        cache, logits = L.decode_step(tc, tp, cache, step_toks)
        jcache, jl = JL.decode_step(jc, jp, jcache, jnp.asarray(step_toks))
        _check_logits(logits, jl)
        _check_cache(cache, jcache)
    assert int(cache["pos"]) == S + 2


@pytest.mark.parametrize("ring", ["every position", "one slot short"])
def test_patch_frontend_decode_against_the_forward(ring):
    """The patch frontend's positions share the ring with the tokens, so a
    decode step equals ``forward(S + 1)`` only where the ring holds
    frontend_len + S + 1 positions.  There the port's prefill and one step
    match its own forward and the JAX package's.  A ring of S + 8 slots
    (``tests/test_arch_smoke.py::test_prefill_decode_matches_forward``'s,
    at its S of 16) is filled by the prefill's 8 + 16 positions, and the
    step writes position 24 over position 0: both packages' steps then
    part from the forward, by the same amount."""
    s = 16
    jc, tc = _configs("internvl2-76b", logits_fp32=True)
    jp, tp = _weights("internvl2-76b")
    full = TokenPipeline(tc, B, s + 1, seed=0).batch_at(0)
    toks, patches = full["tokens"], full["patches"]
    jfwd, _ = jax_get_model(jc).forward(
        jc, jp, {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)})
    jfwd = np.asarray(jfwd[:, -1])
    fwd, _ = get_model(tc).forward(tc, tp, {"tokens": toks,
                                            "patches": patches})
    fwd = fwd[:, -1]
    _check_logits(fwd, jfwd)
    max_len = jc.frontend_len + s + (1 if ring == "every position" else 0)
    assert max_len == (jc.frontend_len + s + 1 if ring == "every position"
                       else s + 8)
    cache, _ = get_model(tc).prefill(
        tc, tp, {"tokens": toks[:, :s], "patches": patches}, max_len)
    cache, dec = L.decode_step(tc, tp, cache, toks[:, -1])
    jcache, _ = JL.prefill(jc, jp, jnp.asarray(toks[:, :s]), max_len,
                           patches=jnp.asarray(patches))
    jcache, jdec = JL.decode_step(jc, jp, jcache, jnp.asarray(toks[:, -1]))
    _check_logits(dec, jdec)
    _check_cache(cache, jcache)
    if ring == "every position":
        _check_logits(dec, jfwd)
        _check_logits(dec, fwd.numpy())
        return
    # parted past that test's tolerance, in both packages alike
    for got in (dec.numpy(), np.asarray(jdec)):
        assert not np.allclose(got, jfwd, rtol=2e-3, atol=2e-3)
    part = float((dec - fwd).abs().max())
    jpart = float(np.abs(np.asarray(jdec) - jfwd).max())
    scale = float(np.abs(jfwd).max())
    assert abs(part - jpart) <= 2e-4 + 2e-5 * scale, (part, jpart)


@pytest.mark.parametrize("arch,pos", [
    ("mixtral-8x7b", 5), ("mixtral-8x7b", 31), ("mixtral-8x7b", 32),
    ("mixtral-8x7b", 77), ("qwen3-0.6b", 0), ("qwen3-0.6b", 47),
    ("qwen3-0.6b", 48), ("qwen3-0.6b", 130), ("granite-moe-3b-a800m", 20)])
def test_attention_decode_through_the_kernel_op_equals_the_jax_einsum(
        arch, pos):
    """``attn_impl="pallas"`` reads the ring as ``kv_len = min(pos + 1,
    Sc)`` keys without a window; the JAX einsum masks by ``slot_pos`` and
    the window.  On rings before, at and past their wrap (mixtral-smoke:
    window 32, Sc 32; qwen3-smoke: no window, Sc 48, QK-norm) they agree
    within the fp32 kernel tolerance, and both write the same slot."""
    jc, tc = _configs(arch, attn_impl="pallas", use_pallas=True)
    jp, tp = _weights(arch)
    sc = JL.cache_len(jc, 48)
    rng = np.random.default_rng(pos)
    kc, vc = (rng.standard_normal((B, sc, jc.n_kv_heads, jc.head_dim))
              .astype(np.float32) for _ in range(2))
    slots = np.arange(sc)
    held = slots + ((pos - 1 - slots) // sc) * sc    # the ring before pos
    slot_pos = np.where(held >= 0, held, -1).astype(np.int32)
    x = rng.standard_normal((B, 1, jc.d_model)).astype(np.float32)
    pa = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    jout, jk, jv, jsp = JC.attention_decode(
        jc, pa, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(slot_pos), jnp.asarray(pos, jnp.int32))
    tk, tv, tsp = (torch.from_numpy(a.copy()) for a in (kc, vc, slot_pos))
    ops.reset_launch_counts()
    out, k2, v2, sp2 = C.attention_decode(
        tc, layer_slice(tp["layers"]["attn"], 0), torch.from_numpy(x), tk,
        tv, tsp, pos)
    assert ops.launch_counts()["decode_attention"] == 0   # plain version
    assert k2 is tk and v2 is tv and sp2 is tsp            # in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **KERNEL_TOL)
    np.testing.assert_array_equal(sp2.numpy(), np.asarray(jsp))
    for got, want in ((k2, jk), (v2, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **KERNEL_TOL)
    plain = dataclasses.replace(tc, attn_impl="blocked")
    tk, tv, tsp = (torch.from_numpy(a.copy()) for a in (kc, vc, slot_pos))
    ref_out = C.attention_decode(plain, layer_slice(tp["layers"]["attn"], 0),
                                 torch.from_numpy(x), tk, tv, tsp, pos)[0]
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), **KERNEL_TOL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b"])
def test_kernel_switches_keep_prefill_and_decode_on_the_jax_results(arch):
    """``attn_impl="pallas"`` and ``use_pallas=True`` (the plain versions
    on the CPU) against the JAX package's own path, decoding past the
    ring's wrap."""
    jc, _ = _configs(arch)
    _, tc = _configs(arch, attn_impl="pallas", use_pallas=True)
    jp, tp = _weights(arch)
    toks = _prompt_tokens(2)
    jcache, jl = JL.prefill(jc, jp, jnp.asarray(toks), 48)
    cache, logits = L.prefill(tc, tp, toks, 48)
    _check_logits(logits, jl)
    step = jax.jit(functools.partial(JL.decode_step, jc))
    rng = np.random.default_rng(3)
    for _ in range(12):
        t = rng.integers(1, 255, B).astype(np.int32)
        cache, logits = L.decode_step(tc, tp, cache, t)
        jcache, jl = step(jp, jcache, jnp.asarray(t))
        _check_logits(logits, jl)
    _check_cache(cache, jcache)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

RAGGED = [list(range(3, 30)), [7, 8, 9, 10, 11], list(range(100, 118))]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x7b"])
def test_engine_greedy_tokens_match_the_jax_engine(arch):
    jc, tc = _configs(arch)
    jp, tp = _weights(arch)
    want = JaxServeEngine(jc, jp, max_len=64).generate(RAGGED, 10)
    got = ServeEngine(tc, tp, max_len=64).generate(RAGGED, 10)
    assert isinstance(got, GenerationResult)
    assert got.tokens == want.tokens
    assert got.steps == want.steps == 27 - 5 + 10
    assert got.tokens_per_s > 0


@pytest.fixture(scope="module")
def qwen3():
    _, tc = _configs("qwen3-0.6b")
    return tc, _weights("qwen3-0.6b")[1]


def test_ragged_batch_matches_single(qwen3):
    """A request's greedy output must not depend on its batch neighbours
    (the replay scheme must reproduce single-request decoding)."""
    cfg, params = qwen3
    eng = ServeEngine(cfg, params, max_len=96)
    p_long = list(range(1, 25))
    p_short = [5, 6, 7, 8, 9, 10]
    solo = eng.generate([p_long], max_new_tokens=8).tokens[0]
    both = eng.generate([p_long, p_short], max_new_tokens=8).tokens
    assert both[0] == solo
    assert len(both[1]) == 8


def test_greedy_deterministic(qwen3):
    cfg, params = qwen3
    eng = ServeEngine(cfg, params, max_len=64)
    prompts = [[1, 2, 3, 4], [9, 8, 7]]
    a = eng.generate(prompts, max_new_tokens=6).tokens
    b = eng.generate(prompts, max_new_tokens=6).tokens
    assert a == b


def test_eos_stops_sequence(qwen3):
    cfg, params = qwen3
    eng = ServeEngine(cfg, params, max_len=64)
    probe = eng.generate([[1, 2, 3, 4]], max_new_tokens=4).tokens[0]
    eos = probe[1]
    want = probe[:probe.index(eos) + 1]   # up to the first eos occurrence
    eng_eos = ServeEngine(cfg, params, max_len=64, eos_id=eos)
    out = eng_eos.generate([[1, 2, 3, 4]], max_new_tokens=8).tokens[0]
    assert out == want            # stopped at the eos token


def test_sampling_follows_its_seed_and_the_engine_checks_its_input(qwen3):
    cfg, params = qwen3
    prompts = [[1, 2, 3, 4], [9, 8, 7]]
    a = ServeEngine(cfg, params, max_len=64, temperature=0.8, seed=3)
    b = ServeEngine(cfg, params, max_len=64, temperature=0.8, seed=3)
    assert (a.generate(prompts, 12).tokens == b.generate(prompts, 12).tokens)
    with pytest.raises(ValueError, match="empty prompt"):
        a.generate([[1, 2], []])
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        a.generate([list(range(1, 60))], 10)
    # over a (1, 1) mesh the engine gives the same draws
    rules = MeshRules(make_local_mesh(device="cpu"))
    c = ServeEngine(cfg, params, max_len=64, temperature=0.8, seed=3,
                    rules=rules)
    assert c.generate(prompts, 12).tokens == ServeEngine(
        cfg, params, max_len=64, temperature=0.8,
        seed=3).generate(prompts, 12).tokens


# ---------------------------------------------------------------------------
# the entry point and the unported families
# ---------------------------------------------------------------------------

def test_serve_entry_point_runs_on_the_cpu(capsys):
    rc = serve.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                     "--device", "cpu", "--attn-impl", "pallas",
                     "--new-tokens", "6"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "arch=granite-moe-smoke batch=4" in out
    assert "(attention pallas, use_pallas False, on cpu)" in out
    assert "tok/s" in out and "sample[1]" in out
    assert serve.main(["--arch", "seamless-m4t-large-v2", "--smoke",
                       "--device", "cpu"]) == 0
    assert "use examples/translate_stream.py" in capsys.readouterr().out
    # one rank alone serves over a (1, 1) mesh; two model shards need
    # two ranks (torchrun)
    assert "[serve] mesh 1x1 (data x model)" in out
    with pytest.raises(ValueError, match="torchrun"):
        serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                    "--model-shards", "2"])


def test_serve_entry_point_use_pallas_reaches_the_rmsnorm_op(capsys,
                                                             monkeypatch):
    """``--use-pallas`` sets the config's ``use_pallas``: every RMSNorm of
    the serving run goes through ``ops.rmsnorm`` (its plain version on the
    CPU), and the greedy samples equal those of the default run."""
    argv = ["--arch", "granite-moe-3b-a800m", "--smoke", "--device", "cpu",
            "--attn-impl", "pallas", "--new-tokens", "4"]
    assert serve.main(argv) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if "sample[" in ln]
    calls = []
    real = ops.rmsnorm

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(ops, "rmsnorm", counted)
    assert serve.main(argv + ["--use-pallas"]) == 0
    out = capsys.readouterr().out
    assert "(attention pallas, use_pallas True, on cpu)" in out
    assert [ln for ln in out.splitlines() if "sample[" in ln] == want
    n_layers = tcfg.get_smoke_config("granite-moe-3b-a800m").n_layers
    assert calls and len(calls) % (2 * n_layers + 1) == 0


@pytest.mark.parametrize("arch,item", [("zamba2-7b", "A13d"),
                                       ("xlstm-125m", "A13e"),
                                       ("seamless-m4t-large-v2", "A13f")])
def test_unported_families_name_their_roadmap_item(arch, item):
    tc = tcfg.get_smoke_config(arch)
    if item == "A13e":
        # ported: the same entries serve the xLSTM family (no ring)
        tc = dataclasses.replace(tc, dtype="float32")
        params = get_model(tc).init(tc, torch.Generator().manual_seed(0),
                                    device="cpu")
        cache, logits = L.prefill(tc, params, np.zeros((1, 2), np.int32), 8)
        assert logits.shape == (1, tc.vocab_size)
        cache, logits = L.decode_step(tc, params, cache, np.zeros(1))
        assert int(cache["pos"]) == 3 and bool(torch.isfinite(logits).all())
        st = L.init_cache(tc, 1, 8, device="cpu")
        assert sorted(st) == ["mlstm_main", "pos", "slstm"]
        assert st["mlstm_main"]["c"].shape == (2, 1, 1, 2, 64, 64)
        assert get_model(tc).prefill(tc, params, {"tokens": np.ones(
            (1, 4), np.int32)}, 8)[1].shape == (1, tc.vocab_size)
        return
    if item == "A13d":
        # ported: the same entries serve the hybrid family; a prompt
        # shorter than conv_width - 1 = 3 prefills but never decodes
        tc = dataclasses.replace(tc, dtype="float32")
        params = get_model(tc).init(tc, torch.Generator().manual_seed(0),
                                    device="cpu")
        cache, logits = L.prefill(tc, params, np.zeros((1, 2), np.int32), 8)
        assert logits.shape == (1, tc.vocab_size)
        with pytest.raises(ValueError, match="fewer than conv_width - 1"):
            L.decode_step(tc, params, cache, np.zeros(1))
        cache, logits = L.prefill(tc, params, np.zeros((1, 3), np.int32), 8)
        cache, logits = L.decode_step(tc, params, cache, np.zeros(1))
        assert int(cache["pos"]) == 4 and bool(torch.isfinite(logits).all())
        assert L.init_cache(tc, 1, 8, device="cpu")["ssm_main"].shape == (
            2, 3, 1, tc.ssm_heads, tc.ssm_head_dim, tc.ssm_state)
        assert get_model(tc).prefill(tc, params, {"tokens": np.ones(
            (1, 4), np.int32)}, 8)[1].shape == (1, tc.vocab_size)
        return
    # A13f, ported: the enc-dec family serves through its Model's
    # prefill / decode_step with frames; ServeEngine and the decoder-only
    # entries of models.lm refuse it
    tc = dataclasses.replace(tc, dtype="float32")
    model = get_model(tc)
    params = model.init(tc, torch.Generator().manual_seed(0), device="cpu")
    frames = np.ones((1, 5, tc.frontend_dim), np.float32)
    cache, logits = model.prefill(tc, params, {"frames": frames,
                                               "tokens": np.zeros((1, 2))}, 8)
    assert logits.shape == (1, tc.vocab_size)
    assert cache["cross_k"].shape == (tc.n_layers, 1, 5, tc.n_kv_heads,
                                      tc.head_dim)
    cache, logits = model.decode_step(tc, params, cache, np.zeros(1))
    assert int(cache["pos"]) == 3 and bool(torch.isfinite(logits).all())
    assert model.init_cache(tc, 1, 8, device="cpu")["cross_v"].shape[2] \
        == tc.frontend_len
    with pytest.raises(ValueError, match="frames"):
        ServeEngine(tc, params, max_len=8)
    with pytest.raises(ValueError, match="models.encdec"):
        L.prefill(tc, params, np.zeros((1, 2)), 8)
    with pytest.raises(ValueError, match="models.encdec"):
        L.init_cache(tc, 1, 8, device="cpu")


def test_serve_batch_example_runs_on_the_cpu():
    """``examples/torch_serve_batch.py``, the twin of
    ``examples/serve_batch.py``, as a user runs it."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join("examples", "torch_serve_batch.py"),
         "--device", "cpu"], cwd=root, capture_output=True, text=True,
        timeout=300, env={k: v for k, v in os.environ.items()
                          if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr
    assert "arch=qwen3-smoke batch=4" in out.stdout
    assert out.stdout.count("sample[") == 2
    assert out.stdout.rstrip().endswith("torch_serve_batch: OK")
