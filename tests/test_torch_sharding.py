"""The port's model on a device mesh (``repro_torch.sharding``,
``models``, ``train``, ``serve``, ``launch``) against the JAX package's on
the CPU.

* In process, metadata only: ``MeshRules.spec``, its ``fallbacks`` and
  ``zero1_spec`` equal JAX's for every leaf of all ten configs'
  ``param_defs`` at full size, and for the dense and MoE decode caches,
  on meshes (1, 1), (1, 2), (2, 2), (4, 2) and (2, 4, 2) with ``pod``,
  fsdp off and on.  JAX's ``MeshRules`` reads only the mesh's axis names
  and device shape, so a stand-in with those serves on this host.
* In process: a ``(1, 1)`` mesh computes what no mesh computes, bit for
  bit (forward, loss, prefill, decode, three training steps), and the
  split-KV combine of ``decode_attention``'s log-sum-exp over blocks of
  a ring equals the whole ring's attention (float32, 2e-6 of the
  largest output; a block with no filled slot gives o = 0, lse = -inf).
* In a subprocess (``_torch_mesh_check.py``): 4 gloo ranks at (2, 2)
  against JAX on 4 forced host devices, with the tolerances stated
  there.
* ``torchrun`` of the launchers with ``--model-shards 2`` on the CPU.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models.api import get_model as jax_get_model
from repro.models.lm import cache_defs as jax_cache_defs
from repro.sharding.rules import MeshRules as JaxMeshRules
from repro.train.optim import zero1_spec as jax_zero1_spec

from repro_torch import configs as tcfg
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels import ref
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models.api import get_model
from repro_torch.models.params import tree_items
from repro_torch.sharding import MeshRules, PartitionSpec, Sharding
from repro_torch.train import step as TS
from repro_torch.train.optim import zero1_spec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (shape, axis names) of the meshes whose layouts are compared
MESHES = [((1, 1), ("data", "model")), ((1, 2), ("data", "model")),
          ((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 4, 2), ("pod", "data", "model"))]


class _JaxMesh:
    """What JAX's ``MeshRules`` and ``zero1_spec`` read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)
        self.shape = dict(zip(names, shape))


def _leaves(defs, path=()):
    if hasattr(defs, "axes") and hasattr(defs, "shape"):
        return [(path, defs)]
    out = []
    for k in sorted(defs):
        out += _leaves(defs[k], path + (k,))
    return out


def _spec(p) -> tuple:
    """A JAX ``PartitionSpec`` as the port's tuple (trailing ``None``s
    stripped)."""
    entries = list(p)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


# ---------------------------------------------------------------------------
# the layouts (metadata only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jcfg.ARCHS)
def test_specs_fallbacks_and_zero1_match_jax_for_every_leaf(arch):
    jc = jcfg.get_config(arch)
    defs = _leaves(jax_get_model(jc).param_defs(jc))
    if jc.family in ("dense", "moe"):
        # the port declares the same leaves
        tc = tcfg.get_config(arch)
        mine = _leaves(get_model(tc).param_defs(tc))
        assert [(p, tuple(d.shape), tuple(d.axes)) for p, d in mine] == \
            [(p, tuple(d.shape), tuple(d.axes)) for p, d in defs]
        for b in (4, 1):           # kv_seq, and long_seq at batch 1
            cache = jax_cache_defs(jc, b, 4096)
            defs = defs + [(("cache", b, k), leaf)
                           for k, leaf in sorted(cache.items())]
    n = 0
    for shape, names in MESHES:
        for fsdp in (False, True):
            jr = JaxMeshRules(_JaxMesh(shape, names), fsdp=fsdp)
            tr = MeshRules(Mesh(names, shape, torch.device("cpu")),
                           fsdp=fsdp)
            for path, d in defs:
                want = jr.spec(d.axes, d.shape)
                got = tr.spec(d.axes, d.shape)
                assert isinstance(got, PartitionSpec)
                assert tuple(got) == _spec(want), (path, shape, fsdp)
                assert tuple(zero1_spec(got, d.shape, tr)) == _spec(
                    jax_zero1_spec(want, d.shape, jr)), (path, shape, fsdp)
                n += 1
            assert tr.fallbacks == jr.fallbacks, (shape, fsdp)
            assert (tr.data_size, tr.model_size) == (jr.data_size,
                                                    jr.model_size)
    assert n > 0
    if arch == "granite-moe-3b-a800m":
        # its vocab of 49,155 divides by nothing: embed replicated
        rules = MeshRules(Mesh(("data", "model"), (1, 2),
                               torch.device("cpu")))
        assert rules.spec(("vocab", "embed"), (49155, 1536)) == ()
        assert rules.fallbacks == [(("vocab", "embed"), 0, "vocab")]


def test_partition_spec_and_sharding_blocks():
    assert PartitionSpec("model", None, None) == ("model",)
    assert PartitionSpec(None, ("pod", "data")).axes(1) == ("pod", "data")
    assert PartitionSpec("model").axes(3) == ()
    mesh = Mesh(("data", "model"), (2, 2), torch.device("cpu"))
    sh = Sharding(mesh, PartitionSpec(("data", "model"), None))
    assert sh.local_shape((8, 3)) == (2, 3)
    assert sh.blocks(0) == 4 and sh.blocks(1) == 1
    assert sh.replicas == [] and sh.owner
    rep = Sharding(mesh, PartitionSpec(None, "model"))
    assert rep.replicas == ["data"]
    one = make_local_mesh(device="cpu")
    t = torch.arange(12.0).reshape(3, 4)
    s1 = MeshRules(one).sharding(("vocab", "embed"), (3, 4))
    assert torch.equal(s1.local(t), t) and torch.equal(s1.gather(t), t)
    assert MeshRules(one).constrain(t, "vocab", "embed", shape=(3, 4)) is t
    with pytest.raises(ValueError, match="block"):
        MeshRules(one).constrain(t, "vocab", "embed", shape=(6, 4))


# ---------------------------------------------------------------------------
# a (1, 1) mesh is no mesh, bit for bit
# ---------------------------------------------------------------------------

def _cfg(arch, dtype, **kw):
    return dataclasses.replace(tcfg.get_smoke_config(arch), dtype=dtype,
                               **kw)


@pytest.mark.parametrize("arch,kw", [
    ("qwen3-0.6b", {}), ("granite-moe-3b-a800m", {}),
    ("granite-moe-3b-a800m", {"moe_impl": "gspmd", "fsdp": True,
                              "attn_impl": "pallas"})])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_by_one_mesh_serves_bit_for_bit(arch, kw, dtype):
    cfg = _cfg(arch, dtype, **kw)
    rules = MeshRules(make_local_mesh(device="cpu"), fsdp=cfg.fsdp)
    model = get_model(cfg)
    g = torch.Generator().manual_seed(3)
    params = model.init(cfg, g, device="cpu")
    mine = model.init(cfg, torch.Generator().manual_seed(3), device="cpu",
                      rules=rules)
    for (p, a), (_, b) in zip(tree_items(params), tree_items(mine)):
        assert torch.equal(a, b), p
    batch = TokenPipeline(cfg, 4, 12, seed=1).batch_at(0)
    for a, b in zip(model.forward(cfg, params, batch),
                    model.forward(cfg, mine, batch, rules)):
        assert torch.equal(a, b)
    assert torch.equal(model.loss(cfg, params, batch)[0],
                       model.loss(cfg, mine, batch, rules)[0])
    c0, l0 = model.prefill(cfg, params, batch, 20)
    c1, l1 = model.prefill(cfg, mine, batch, 20, rules)
    for i in range(3):
        assert torch.equal(l0, l1), i
        nxt = torch.argmax(l0, -1)
        c0, l0 = model.decode_step(cfg, params, c0, nxt)
        c1, l1 = model.decode_step(cfg, mine, c1, nxt, rules)
    for k in c0:
        assert torch.equal(c0[k], c1[k]), k


@pytest.mark.parametrize("arch,kw,tkw", [
    ("qwen3-0.6b", {"microbatch": 2}, {"grad_compress": True}),
    ("granite-moe-3b-a800m", {"fsdp": True, "moe_impl": "gspmd"},
     {"zero1": False})])
def test_one_by_one_mesh_trains_bit_for_bit(arch, kw, tkw):
    cfg = _cfg(arch, "float32", **kw)
    rules = MeshRules(make_local_mesh(device="cpu"), fsdp=cfg.fsdp)
    tc = TS.TrainConfig(total_steps=10, warmup_steps=1, **tkw)
    shard = TS.state_shardings(cfg, rules, tc)
    states = [TS.init_train_state(cfg, torch.Generator().manual_seed(0),
                                  device="cpu"),
              TS.init_train_state(cfg, torch.Generator().manual_seed(0),
                                  device="cpu", shardings=shard)]
    steps = [TS.make_train_step(cfg, None, tc),
             TS.make_train_step(cfg, rules, tc)]
    pipe = TokenPipeline(cfg, 4, 12, seed=0)
    for i in range(3):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
        rows = []
        for j in range(2):
            states[j], m = steps[j](states[j], batch)
            rows.append({k: v.clone() for k, v in m.items()})
        for k in rows[0]:
            assert torch.equal(rows[0][k], rows[1][k]), (i, k)
    for (p, a), (_, b) in zip(tree_items(states[0]), tree_items(states[1])):
        assert torch.equal(a, b), p


# ---------------------------------------------------------------------------
# split-KV decode: the log-sum-exp of decode_attention's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_lse_combines_blocks_of_a_ring(dtype):
    """Each block of slots attended alone (the kernel's plain version with
    ``return_lse``), then combined with the ranks' formula: the whole
    ring's output, and the lse equals float64's."""
    g = torch.Generator().manual_seed(0)
    b, hq, hkv, s, d, blocks = 2, 8, 2, 64, 64, 4
    q = torch.randn((b, hq, d), generator=g).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=g).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=g).to(dtype)
    for kv_len in (1, 20, 33, 64):
        want = ref.decode_attention_ref(q, k, v, kv_len=kv_len)
        o, lse = ref.decode_attention_ref(q, k, v, kv_len=kv_len,
                                          return_lse=True)
        assert torch.equal(o, want)
        qf = q.double().reshape(b, hkv, hq // hkv, d) * d ** -0.5
        sc = torch.einsum("bhgd,bhkd->bhgk", qf, k.double()[:, :, :kv_len])
        np.testing.assert_allclose(
            lse.numpy(), torch.logsumexp(sc, -1).reshape(b, hq).numpy(),
            rtol=1e-5, atol=1e-5)
        n = s // blocks
        parts = []
        for i in range(blocks):
            kl = max(0, min(kv_len - i * n, n))
            parts.append(ref.decode_attention_ref(
                q, k[:, :, i * n:(i + 1) * n], v[:, :, i * n:(i + 1) * n],
                kv_len=kl, return_lse=True))
            if kl == 0:
                assert torch.equal(parts[-1][0], torch.zeros_like(q))
                assert torch.isneginf(parts[-1][1]).all()
        top = torch.stack([p[1] for p in parts]).amax(0)
        w = [torch.exp(p[1] - top) for p in parts]
        got = sum(p[0].float() * wi[..., None] for p, wi in zip(parts, w)) \
            / sum(w)[..., None]
        scale = float(want.float().abs().max())
        tol = 2e-6 if dtype == torch.float32 else 2 ** -8
        assert float((got - want.float()).abs().max()) <= tol * scale, \
            kv_len
    with pytest.raises(ValueError, match="return_lse"):
        ref.decode_attention_ref(q, k, v, kv_len=0)


# ---------------------------------------------------------------------------
# several ranks
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"),
                                         os.path.join(ROOT, "tests")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_four_gloo_ranks_match_jax_on_a_forced_two_by_two_mesh():
    """Blocks, forward, serving, training and checkpoints of the port at
    (2, 2) against JAX's (``_torch_mesh_check.py``)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_mesh_check.py")],
        capture_output=True, text=True, env=_env(), timeout=900)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "OK"
    for want in ("collectives over ('model', 'data'): all_gather",
                 "dense: 13 blocks of rank 0 equal to the JAX shards",
                 "moe_vocab_fallback: forward logits within",
                 "moe_gspmd: forward logits within",
                 "moe_long_seq (B 1): prefill and 4 decode steps, tokens "
                 "equal",
                 "dense_zero1_compress: 3 steps",
                 "moe_fsdp_gspmd: 3 steps",
                 "the JAX 4-device checkpoint restores on 2 ranks",
                 "the port's 4-rank checkpoint restores in JAX"):
        assert any(ln.startswith(want) for ln in lines), want


def test_launchers_under_torchrun_on_the_cpu(tmp_path):
    """``--model-shards 2``: training at 4 ranks with checkpoints, resumed
    at 2 ranks (elastic restore), and serving at 2 ranks."""
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone"]
    common = ["--smoke", "--device", "cpu", "--model-shards", "2"]
    train = ["-m", "repro_torch.launch.train", "--arch", "h2o-danube-1.8b",
             "--global-batch", "4", "--seq", "16", "--log-every", "2",
             "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "ck")]
    proc = subprocess.run(run + ["--nproc-per-node", "4"] + train + common
                          + ["--steps", "2"], capture_output=True,
                          text=True, env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("[train] step     2 loss") == 1
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_0000002"]
    proc = subprocess.run(run + ["--nproc-per-node", "2"] + train + common
                          + ["--steps", "3", "--resume", "auto"],
                          capture_output=True, text=True, env=_env(),
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[train] resumed from step 2" in proc.stdout
    assert "[train] step     3 loss" in proc.stdout
    proc = subprocess.run(
        run + ["--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
               "--arch", "granite-moe-3b-a800m", "--new-tokens", "4",
               "--attn-impl", "pallas"] + common,
        capture_output=True, text=True, env=_env(), timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("[serve] mesh 1x2 (data x model)") == 1
    assert "[serve] sample[1]:" in proc.stdout
