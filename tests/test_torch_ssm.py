"""Parity of the port's Mamba2 (SSD) layer, ``repro_torch.models.ssm``,
with the JAX package's ``repro.models.ssm`` on the CPU, in float32 on the
zamba2 smoke config (d_model 64, d_inner 128, 8 heads of 16, state 16,
chunk 16) with the same weights (the JAX layer converted by
``from_jax_params``) and inputs drawn from a seed with numpy.

Each output is held within 2e-5 of its largest magnitude: the two
packages sum in float32 in other orders (the JAX package's chunk-state
recurrence is an associative scan, the port's a loop).  The depthwise
conv, whose taps both packages sum in the same order, is held bit for
bit; the conv windows handed over hold the input projections, which the
packages' matmuls round a few ulps apart."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import lm as JL
from repro.models import ssm as JS
from repro.models.api import get_model as jax_get_model
from repro.models.params import init_params

from repro_torch import configs as tcfg
from repro_torch.models import ssm as TS
from repro_torch.models.params import from_jax_params

TOL = 2e-5
ARCH = "zamba2-7b"
B = 2


def _cfgs():
    jc = dataclasses.replace(jcfg.get_smoke_config(ARCH), dtype="float32")
    tc = dataclasses.replace(tcfg.get_smoke_config(ARCH), dtype="float32")
    return jc, tc


@pytest.fixture(scope="module")
def layer():
    """One Mamba2 layer's weights (the JAX package's init), with
    nonzero conv biases, dt biases and A_log so every term counts."""
    jc, tc = _cfgs()
    p = {k: np.asarray(v) for k, v in init_params(
        JL._mamba_defs(jc), jax.random.PRNGKey(3)).items()}
    rng = np.random.default_rng(5)
    for k in ("conv_b", "dt_bias", "A_log"):
        p[k] = rng.normal(0, 0.5, p[k].shape).astype(np.float32)
    jl = {k: jnp.asarray(v) for k, v in p.items()}
    return jc, tc, jl, dict(from_jax_params(p, device="cpu"))


def _x(s, seed=0, b=B, d=64):
    return np.random.default_rng(seed).normal(0, 1, (b, s, d)).astype(
        np.float32)


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max()) / scale
    assert err <= TOL, f"{what}: {err:.3e} of the max > {TOL}"


@pytest.mark.parametrize("decode", [False, True])
def test_depthwise_causal_conv_matches_jax(decode):
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.5, (4, 24)).astype(np.float32)
    if decode:
        x = rng.normal(0, 1, (3, 1, 24)).astype(np.float32)
        st = rng.normal(0, 1, (3, 3, 24)).astype(np.float32)
        jy, jst = JS._depthwise_causal_conv(jnp.asarray(x), jnp.asarray(w),
                                            jnp.asarray(st))
        ty, tst = TS._depthwise_causal_conv(torch.from_numpy(x),
                                            torch.from_numpy(w),
                                            torch.from_numpy(st))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
        _close(ty, jy, "decode conv")     # XLA's einsum sums the 4 taps
    else:
        x = rng.normal(0, 1, (3, 11, 24)).astype(np.float32)
        jy, _ = JS._depthwise_causal_conv(jnp.asarray(x), jnp.asarray(w))
        ty, none = TS._depthwise_causal_conv(torch.from_numpy(x),
                                             torch.from_numpy(w))
        assert none is None
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("s", [12, 16, 32, 48])
def test_ssd_forward_matches_jax(layer, s):
    """S within one chunk (12, 16), 2 and 3 chunks; with the state."""
    jc, tc, jl, tl = layer
    x = _x(s, seed=s)
    jy, jst, jcs = jax.jit(functools.partial(
        JS.ssd_forward, jc, return_state=True))(jl, jnp.asarray(x))
    ty, tst, tcs = TS.ssd_forward(tc, tl, torch.from_numpy(x),
                                  return_state=True)
    _close(ty, jy, f"ssd_forward S={s}")
    _close(tst, jst, f"final SSM state S={s}")
    _close(tcs, jcs, f"conv window S={s}")     # projections: ulps apart
    assert torch.equal(TS.ssd_forward(tc, tl, torch.from_numpy(x)), ty)


def test_ssd_decode_matches_jax(layer):
    jc, tc, jl, tl = layer
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (B, 1, 64)).astype(np.float32)
    st = rng.normal(0, 1, (B, 8, 16, 16)).astype(np.float32)
    cs = rng.normal(0, 1, (B, 3, 160)).astype(np.float32)
    jy, jst, jcs = jax.jit(functools.partial(JS.ssd_decode, jc))(
        jl, jnp.asarray(x), jnp.asarray(st), jnp.asarray(cs))
    ty, tst, tcs = TS.ssd_decode(tc, tl, torch.from_numpy(x),
                                 torch.from_numpy(st), torch.from_numpy(cs))
    _close(ty, jy, "ssd_decode y")
    _close(tst, jst, "ssd_decode state")
    _close(tcs, jcs, "ssd_decode conv window")


@pytest.mark.parametrize("s,n", [(12, 4), (32, 16)])
def test_prefill_handoff_then_decode_equals_a_longer_forward(layer, s, n):
    """``ssd_forward(return_state)`` over S positions, then n decode
    steps, gives the outputs of one forward over S + n positions (within
    one chunk, or a whole number of them)."""
    _, tc, _, tl = layer
    x = torch.from_numpy(_x(s + n, seed=11))
    full = TS.ssd_forward(tc, tl, x)
    y, st, cs = TS.ssd_forward(tc, tl, x[:, :s], return_state=True)
    outs = [y]
    for t in range(s, s + n):
        yt, st, cs = TS.ssd_decode(tc, tl, x[:, t:t + 1], st, cs)
        outs.append(yt)
    _close(torch.cat(outs, 1), full.numpy(), f"handoff at S={s}")


@pytest.mark.parametrize("s", [17, 24, 40])
def test_both_packages_refuse_partial_chunks(layer, s):
    """A sequence longer than the chunk (16) and not a multiple of it: the
    JAX layer asserts, the port raises ``ValueError``, the model's
    ``forward`` and ``prefill`` too."""
    jc, tc, jl, tl = layer
    x = _x(s)
    with pytest.raises(AssertionError):
        JS.ssd_forward(jc, jl, jnp.asarray(x))
    with pytest.raises(ValueError, match="ssm_chunk"):
        TS.ssd_forward(tc, tl, torch.from_numpy(x))
    from repro_torch.models import lm as L
    toks = np.zeros((1, s), np.int32)
    params = {"embed": torch.zeros(256, 64)}
    with pytest.raises(ValueError, match="ssm_chunk"):
        L.prefill(tc, params, toks, 64)
    with pytest.raises(AssertionError):
        jax.eval_shape(functools.partial(JL.forward, jc),
                       jax_get_model(jc).structs(jc), jnp.asarray(toks))
