"""Subprocess body: the JAX package's dry-run stand-ins on its production
meshes, for ``test_torch_dryrun.py``.

JAX's ``NamedSharding`` needs a concrete mesh, so this process forces 512
host devices before JAX starts (as ``repro.launch.dryrun`` does) and
writes, for every arch on the (16, 16) and (2, 16, 16) meshes, each
leaf's global shape, dtype, ``PartitionSpec`` and per-device shard
bytes of:

* ``param_structs`` in float32 and bfloat16;
* ``serve_param_structs`` under fsdp;
* ``cache_structs`` at ``decode_32k``, and at ``long_500k`` where
  ``shape_applicable``;
* ``input_specs`` of every shape;
* ``state_structs`` with ZeRO-1 on and off.

    python tests/_torch_dryrun_structs.py OUT.json
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro.configs import ARCHS, SHAPES, get_config, shape_applicable  # noqa: E402,E501
from repro.launch.dryrun import serve_param_structs  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models.api import get_model, input_specs  # noqa: E402
from repro.sharding.rules import MeshRules  # noqa: E402
from repro.train.step import TrainConfig, state_structs  # noqa: E402


def _spec(s) -> list:
    out = []
    for e in tuple(s.sharding.spec):
        out.append(list(e) if isinstance(e, tuple) else e)
    while out and out[-1] is None:
        out.pop()
    return out


def leaves(tree) -> dict:
    """{"a/b/c": [shape, dtype, spec, shard bytes]}."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        shard = s.sharding.shard_shape(s.shape)
        out[key] = [list(s.shape), str(np.dtype(s.dtype)), _spec(s),
                    math.prod(shard) * np.dtype(s.dtype).itemsize]
    return out


def main(path: str) -> None:
    out = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        label = "2pod" if multi else "1pod"
        for arch in ARCHS:
            cfg = get_config(arch)
            model = get_model(cfg)
            rules = MeshRules(mesh, fsdp=cfg.fsdp)
            cell = {
                "params_f32": leaves(model.structs(cfg, rules)),
                "params_bf16": leaves(model.structs(cfg, rules,
                                                    dtype=jnp.bfloat16)),
            }
            fcfg = dataclasses.replace(cfg, fsdp=True)
            cell["serve_fsdp"] = leaves(serve_param_structs(
                fcfg, model, MeshRules(mesh, fsdp=True)))
            for name in ("decode_32k", "long_500k"):
                shape = SHAPES[name]
                if shape_applicable(cfg, shape)[0]:
                    cell[f"cache_{name}"] = leaves(model.cache_structs(
                        cfg, shape.global_batch, shape.seq_len, rules,
                        dtype=jnp.bfloat16))
            for name, shape in SHAPES.items():
                cell[f"inputs_{name}"] = leaves(input_specs(cfg, shape,
                                                            rules))
            for zero1 in (True, False):
                cell[f"state_zero1_{zero1}"] = leaves(state_structs(
                    cfg, rules, TrainConfig(zero1=zero1)))
            out[f"{arch}|{label}"] = cell
    with open(path, "w") as f:
        json.dump(out, f)
    print("OK")


if __name__ == "__main__":
    main(sys.argv[1])
