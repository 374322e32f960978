"""The port's dry run (``repro_torch.launch.{dryrun,mine_dryrun}``, the
stand-ins of ``models``/``train``, ``launch.mesh.make_production_mesh``)
against the JAX package's.

* The stand-ins: a subprocess with 512 JAX host devices
  (``_torch_dryrun_structs.py``) writes every leaf of every arch's
  parameter (float32, bfloat16, and serving's ZeRO-extended fsdp
  layout), cache (``decode_32k``, and ``long_500k`` where it applies),
  input (each shape) and train-state (ZeRO-1 on and off) stand-ins on
  the (16, 16) and (2, 16, 16) production meshes; the port's equal them
  in global shape, dtype, ``PartitionSpec`` and per-device shard bytes.
  Tokens and labels are int64 in the port (its index type) where they
  are int32 in JAX: their shard holds the same elements, at twice the
  bytes.
* ``launch.dryrun.main`` and ``launch.mine_dryrun.main`` on one small
  cell each, in process: rc 0 and ``ok`` rows; the mining cells record
  the three mining kernels and trace none of their plain versions.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import (ARCHS, SHAPES, get_config,
                                 shape_applicable)
from repro_torch.kernels import ref
from repro_torch.launch import dryrun, mine_dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import get_model, input_specs
from repro_torch.models.params import tree_items
from repro_torch.sharding import MeshRules
from repro_torch.train.step import TrainConfig, state_structs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"1pod": False, "2pod": True}
#: leaves that are int32 in JAX and int64 (the index type) in the port
INDEX_LEAVES = {"tokens", "labels"}


@pytest.fixture(scope="module")
def jax_structs(tmp_path_factory):
    out = tmp_path_factory.mktemp("structs") / "structs.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_dryrun_structs.py"), str(out)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


_RULES: dict = {}


def _rules(label: str, fsdp: bool) -> MeshRules:
    key = (label, fsdp)
    if key not in _RULES:
        _RULES[key] = MeshRules(make_production_mesh(
            multi_pod=MESHES[label]), fsdp=fsdp)
    return _RULES[key]


def _leaves(tree) -> dict:
    """{"a/b/c": [shape, dtype, spec, shard bytes]} of a Struct tree."""
    out = {}
    for path, s in tree_items(tree):
        spec = [list(e) if isinstance(e, tuple) else e
                for e in s.sharding.spec]
        out["/".join(path)] = [list(s.shape), str(s.dtype)[6:], spec,
                               s.nbytes]
    return out


def _port_structs(arch: str, label: str) -> dict:
    cfg = get_config(arch)
    model = get_model(cfg)
    rules = _rules(label, cfg.fsdp)
    cell = {"params_f32": _leaves(model.structs(cfg, rules)),
            "params_bf16": _leaves(model.structs(cfg, rules,
                                                 dtype=torch.bfloat16))}
    fcfg = dataclasses.replace(cfg, fsdp=True)
    cell["serve_fsdp"] = _leaves(dryrun.serve_param_structs(
        fcfg, model, _rules(label, True)))
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        if shape_applicable(cfg, shape)[0]:
            cell[f"cache_{name}"] = _leaves(model.cache_structs(
                cfg, shape.global_batch, shape.seq_len, rules,
                dtype=torch.bfloat16))
    for name, shape in SHAPES.items():
        cell[f"inputs_{name}"] = _leaves(input_specs(cfg, shape, rules))
    for zero1 in (True, False):
        cell[f"state_zero1_{zero1}"] = _leaves(state_structs(
            cfg, rules, TrainConfig(zero1=zero1)))
    return cell


@pytest.mark.parametrize("label", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_stand_ins_match_jax(jax_structs, arch, label):
    want = jax_structs[f"{arch}|{label}"]
    got = _port_structs(arch, label)
    assert sorted(got) == sorted(want)
    for group in want:
        assert sorted(got[group]) == sorted(want[group]), group
        for leaf, (shape, dtype, spec, nbytes) in want[group].items():
            g = got[group][leaf]
            if leaf in INDEX_LEAVES and dtype == "int32":
                dtype, nbytes = "int64", 2 * nbytes
            assert g == [shape, dtype, spec, nbytes], (group, leaf, g)


def test_production_meshes():
    one, two = (make_production_mesh(multi_pod=m) for m in (False, True))
    assert (one.axis_names, one.sizes) == (("data", "model"), (16, 16))
    assert (two.axis_names, two.sizes) == (("pod", "data", "model"),
                                           (2, 16, 16))
    far = make_production_mesh(multi_pod=True, rank=300)
    assert far.coords == (1, 2, 12) and far.device.type == "meta"
    assert far.dry and not far.staged


def test_dryrun_main_on_one_cell(tmp_path, capsys):
    out = tmp_path / "d.jsonl"
    rc = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                      "--mesh", "single", "--out", str(out)])
    assert rc == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["arch"], r["shape"], r["mesh"], r["status"])
            for r in rows] == [("qwen3-0.6b", "decode_32k", "1pod", "ok")]
    r = rows[0]
    assert r["fits"] and r["n_devices"] == 256 and r["step_s"] > 0
    # decode over the ring's slots split on ``model``: its all-reduces
    assert r["by_kind"]["all-reduce"][0] > 0
    # --resume skips the cell; a skip row names its reason
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                        "--mesh", "single", "--out", str(out),
                        "--resume"]) == 0
    assert len(out.read_text().splitlines()) == 1
    assert dryrun.run_cell("qwen3-0.6b", "long_500k",
                           make_production_mesh(), "1pod")["status"] == \
        "skip"
    assert "[dryrun] done: 1 ok, 0 skip, 0 error" in capsys.readouterr().out


def test_mine_dryrun_main_records_the_kernels(tmp_path, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a plain version traced in a kernel's place")
    for name in ("segment_reduce_ref", "radix_histogram_ref",
                 "radix_rank_ref", "radix_pass_ref"):
        monkeypatch.setattr(ref, name, plain)
    out = tmp_path / "m.jsonl"
    assert mine_dryrun.main(["--mesh", "single", "--n-tuples", "65536",
                             "--out", str(out)]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["cell"], r["mesh"]) for r in rows] == [
        ("tricluster/replicate", "1pod"), ("tricluster/shuffle", "1pod"),
        ("tricluster/replicate", "1pod-full"),
        ("tricluster/shuffle", "1pod-full")]
    for r in rows:
        assert r["status"] == "ok"
        calls = {k: v[0] for k, v in r["kernels"].items()}
        # arity 4: a segment sweep and a histogram a mode, one more
        # histogram and 8 fused passes for Stage 3, and each mode's sort
        assert calls["segment_reduce"] == 4
        assert calls["radix_histogram"] == 5
        assert calls["radix_rank"] > 8
    assert rows[1]["by_kind"]["all-to-all"][0] > 0
