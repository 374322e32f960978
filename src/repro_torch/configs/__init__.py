"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from . import (granite_3_8b, granite_moe_3b, h2o_danube_1b8, internvl2_76b,
               mistral_nemo_12b, mixtral_8x7b, qwen3_0b6, seamless_m4t_l2,
               xlstm_125m, zamba2_7b)

_MODULES = {
    "zamba2-7b": zamba2_7b,
    "xlstm-125m": xlstm_125m,
    "mixtral-8x7b": mixtral_8x7b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "h2o-danube-1.8b": h2o_danube_1b8,
    "qwen3-0.6b": qwen3_0b6,
    "granite-3-8b": granite_3_8b,
    "seamless-m4t-large-v2": seamless_m4t_l2,
    "internvl2-76b": internvl2_76b,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke()


def cells():
    """All (arch, shape, runs, skip_reason) dry-run grid cells — 40 total."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            runs, why = shape_applicable(cfg, shape)
            out.append((arch, shape.name, runs, why))
    return out


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "get_smoke_config", "cells", "shape_applicable"]
