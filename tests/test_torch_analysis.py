"""The port's dry-trace analysis (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``).

* Tensor-core FLOPs: a ``meta`` trace's ``tensor_flops`` equals the
  ``mxu_flops`` of ``repro.analysis.hlo.profile_module`` over the jitted
  JAX function compiled for one CPU device, exactly: the forward of five
  families' smoke configs and of internvl2's patch front end, a qwen3
  training step (remat on), and a decode step of qwen3, granite-moe and
  seamless.  zamba2's forward is exact; its decode step and training
  step differ by products that both packages compute but only XLA
  writes as ``dot``s (each the same arithmetic, elementwise in the
  port), computed from the config (:func:`_zamba2_decode_term`,
  :func:`_zamba2_train_term`).
* ``Collective.wire_bytes`` equals JAX's for each kind at group sizes 1,
  2, 16 and 256.
* ``RooflineReport``'s derived terms and ``report.roofline_table`` equal
  JAX's for the same inputs and hardware.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.analysis import hlo as JH
from repro.analysis import report as JREP
from repro.analysis import roofline as JR
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models.api import get_model as jax_get_model
from repro.sharding.rules import MeshRules as JaxMeshRules
from repro.train import step as JS

from repro_torch import configs as tcfg
from repro_torch.analysis import ops as O
from repro_torch.analysis import report as TREP
from repro_torch.analysis import roofline as TR
from repro_torch.launch.mesh import make_dry_mesh
from repro_torch.models.api import get_model
from repro_torch.models.params import ParamTree, struct_locals
from repro_torch.sharding import MeshRules
from repro_torch.train import step as TS

B, S, S_TRAIN, SLOTS = 2, 32, 16, 32


def _mxu(fn, *args) -> float:
    """JAX's product FLOPs of ``fn`` compiled for one CPU device."""
    compiled = jax.jit(fn).lower(*args).compile()
    return JH.profile_module(compiled.as_text()).mxu_flops


def _jax_structs(batch: dict) -> dict:
    return {k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype)
            for k, v in batch.items()}


def _meta(batch: dict) -> dict:
    """The port's stand-ins of a batch: int64 indices, float32 frames."""
    return {k: torch.empty(np.shape(v), device="meta",
                           dtype=torch.int64 if np.asarray(v).dtype.kind
                           in "iu" else torch.float32)
            for k, v in batch.items()}


def _configs(arch, **kw):
    return (dataclasses.replace(jcfg.get_smoke_config(arch), **kw),
            dataclasses.replace(tcfg.get_smoke_config(arch), **kw))


def forward_flops(arch):
    jc, tc = _configs(arch)
    jm, tm = jax_get_model(jc), get_model(tc)
    batch = JaxTokenPipeline(jc, B, S, seed=0).batch_at(0)
    batch.pop("labels", None)
    jp = jax.eval_shape(lambda: jm.init(jc, jax.random.PRNGKey(0)))
    want = _mxu(lambda p, b: jm.forward(jc, p, b), jp, _jax_structs(batch))
    got = O.trace(lambda p, b: tm.forward(tc, p, b),
                  struct_locals(tm.structs(tc)), _meta(batch))
    return got.profile.tensor_flops, want, tc


def decode_flops(arch):
    jc, tc = _configs(arch)
    jm, tm = jax_get_model(jc), get_model(tc)
    jp = jax.eval_shape(lambda: jm.init(jc, jax.random.PRNGKey(0)))
    jcache = jax.eval_shape(lambda: jm.init_cache(jc, B, SLOTS))
    want = _mxu(lambda p, c, t: jm.decode_step(jc, p, c, t), jp, jcache,
                jax.ShapeDtypeStruct((B,), jnp.int32))
    got = O.trace(lambda p, c, t: tm.decode_step(tc, p, c, t),
                  struct_locals(tm.structs(tc)),
                  struct_locals(tm.cache_structs(tc, B, SLOTS, None)),
                  torch.empty((B,), dtype=torch.int64, device="meta"))
    return got.profile.tensor_flops, want, tc


def train_flops(arch, **kw):
    jc, tc = _configs(arch, **kw)
    batch = JaxTokenPipeline(jc, B, S_TRAIN, seed=0).batch_at(0)
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    with mesh:
        step = JS.make_train_step(jc, JaxMeshRules(mesh), JS.TrainConfig())
        st = jax.eval_shape(lambda: JS.init_train_state(
            jc, jax.random.PRNGKey(1)))
        want = _mxu(step, st, _jax_structs(batch))
    rules = MeshRules(make_dry_mesh((1, 1), ("data", "model")))
    state = struct_locals(TS.state_structs(tc, rules))
    state["params"] = ParamTree.from_tensors(state["params"],
                                             requires_grad=True)
    got = O.trace(TS.make_train_step(tc, rules, TS.TrainConfig()), state,
                  _meta(batch))
    return got.profile.tensor_flops, want, tc


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "zamba2-7b", "xlstm-125m",
                                  "seamless-m4t-large-v2", "internvl2-76b"])
def test_forward_tensor_flops_equal_jax(arch):
    """Exact.  granite-moe's after the static-shape MoE dispatch (before
    it, the boolean-mask index had no ``meta`` kernel); xlstm's after the
    mLSTM's forward stopped computing the last chunk's state update that
    nothing reads (XLA drops it as dead code: one (B·H, P, S) x (S, P)
    and one (B·H, 1, S) x (S, P) product a layer, 2,129,920 at B 2 x
    S 32)."""
    got, want, _ = forward_flops(arch)
    assert got == want > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "seamless-m4t-large-v2"])
def test_decode_tensor_flops_equal_jax(arch):
    got, want, _ = decode_flops(arch)
    assert got == want > 0


def test_train_step_tensor_flops_equal_jax():
    """qwen3-0.6b's step with remat: the forward, its recompute and the
    backward."""
    got, want, _ = train_flops("qwen3-0.6b")
    assert got == want > 0


def _mamba_layers(cfg) -> int:
    """The Mamba2 layers of the hybrid pattern (every layer is one)."""
    return cfg.n_layers


def _zamba2_decode_term(cfg) -> int:
    """The Mamba2 decode step's depthwise conv over its window: JAX's
    ``einsum("bwc,wc->bc")`` is a ``dot`` (2·B·W·C, C = d_inner + 2N),
    the port's ``_depthwise_causal_conv`` the same multiply-adds
    elementwise; one a Mamba2 layer."""
    c = cfg.d_inner + 2 * cfg.ssm_state
    return _mamba_layers(cfg) * 2 * B * cfg.conv_width * c


def _zamba2_train_term(cfg) -> int:
    """In the training step's backward XLA writes three contractions of
    each Mamba2 layer's SSD as ``dot``s where autograd's are a multiply
    and a sum: the cotangents of the chunk-state product's decay
    (contracted over the state N) and ``B`` (over the heads H), and of
    ``dt`` in ``x·dt`` (over the head width P); 2·B·S·H·(2N + P) a
    layer, the same arithmetic on both sides."""
    return _mamba_layers(cfg) * 2 * B * S_TRAIN * cfg.ssm_heads * (
        2 * cfg.ssm_state + cfg.ssm_head_dim)


def test_zamba2_decode_tensor_flops_equal_jax_but_the_conv():
    got, want, tc = decode_flops("zamba2-7b")
    assert got + _zamba2_decode_term(tc) == want
    assert _zamba2_decode_term(tc) == 17_920


def test_zamba2_train_step_tensor_flops_equal_jax_but_three_products():
    """At 3 layers (one group: three Mamba2 layers and the shared block)
    to keep the compile short; at the smoke config's 7 the term is
    172,032 of 8.1109e7."""
    got, want, tc = train_flops("zamba2-7b", n_layers=3)
    assert got + _zamba2_train_term(tc) == want
    assert _zamba2_train_term(dataclasses.replace(tc, n_layers=7)) == \
        172_032


@pytest.mark.parametrize("n", [1, 2, 16, 256])
@pytest.mark.parametrize("kind", JH.COLLECTIVE_OPS)
def test_wire_bytes_equal_jax(kind, n):
    for nbytes in (0, 4, 1000, 12_884_912_128):
        j = JH.Collective(kind, nbytes, 2 * nbytes, n, "c")
        t = O.Collective(kind, nbytes, 2 * nbytes, n)
        assert t.wire_bytes == j.wire_bytes


def _reports():
    """The same inputs to both packages' ``RooflineReport``, at the
    port's H100 constants; the port's peak is JAX's argument + output +
    temp bytes."""
    hw = TR.H100
    jhw = JR.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                link_bw=hw.link_bw, hbm_bytes=hw.hbm_bytes)
    out = []
    for i, (flops, nbytes, coll, arg, outb, temp) in enumerate([
            (3.1e13, 2.2e11, 4_000_000_000, 6e9, 1e9, 2e9),
            (1e9, 5e12, 10, 5e10, 1e10, 4e10),
            (1e12, 1e9, 9_000_000_000_000, 1e6, 0, 0)]):
        common = dict(arch=f"a{i}", shape="train_4k", mesh="1pod",
                      n_devices=256, flops_per_device=flops,
                      bytes_per_device=nbytes, coll_operand_bytes=coll,
                      coll_wire_bytes=2 * coll, argument_bytes=int(arg),
                      output_bytes=int(outb), temp_bytes=int(temp),
                      model_flops_total=int(3e15),
                      by_kind={"all-reduce": (3, coll, 2 * coll)})
        out.append((JR.RooflineReport(**common, hw=jhw),
                    TR.RooflineReport(**common, hw=hw,
                                      peak_bytes=int(arg + outb + temp))))
    return out


def test_roofline_terms_equal_jax():
    for j, t in _reports():
        for name in ("compute_s", "memory_s", "collective_s",
                     "collective_wire_s", "bound", "step_s",
                     "useful_ratio", "mfu", "device_bytes", "fits"):
            assert getattr(t, name) == getattr(j, name), name
        assert t.row() == j.row()


def test_roofline_table_equals_jax():
    rows = []
    for j, t in _reports():
        jd, td = j.to_dict(), t.to_dict()
        jd.update(status="ok", compile_s=1.0)
        td.update(status="ok", trace_s=1.0)
        rows.append((jd, td))
    skip = {"arch": "x", "shape": "long_500k", "mesh": "1pod",
            "status": "skip", "reason": "SKIP(full-attention): no"}
    err = {"arch": "y", "shape": "train_4k", "mesh": "1pod",
           "status": "error", "error": "ValueError: a layout"}
    jrows = [j for j, _ in rows] + [skip, err]
    trows = [t for _, t in rows] + [skip, err]
    assert TREP.roofline_table(trows, "1pod") == JREP.roofline_table(
        jrows, "1pod")
    assert TREP.HEADER == JREP.HEADER
    assert "fit 80 GB/card" in TREP.dryrun_summary(trows)
    assert TR.H100.hbm_bytes == 80e9 and TR.H100.peak_flops == 989.4e12
