"""Unified model API: one ``Model`` namespace per config, dispatched on
family.  Port of ``repro.models.api``.

  model = get_model(cfg)
  params = model.init(cfg, generator, device=device)
  logits, aux = model.forward(cfg, params, batch)
  cache, logits = model.prefill(cfg, params, inputs, max_len)
  cache, logits = model.decode_step(cfg, params, cache, tokens)

``loss`` raises ``NotImplementedError`` until the training slice lands
(ROADMAP A13b); so do the families other than ``dense`` and ``moe``
(A13d-f).  ``cache_structs`` (sharded dry-run inputs) comes with the mesh
(A13c).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig, check_ported
from . import lm
from .params import ParamTree, init_params


class Model(NamedTuple):
    param_defs: Callable
    forward: Callable          # (cfg, params, batch, rules) -> (logits, aux)
    loss: Callable             # (cfg, params, batch, rules) -> (loss, metrics)
    prefill: Callable          # (cfg, params, inputs, max_len, rules) -> (cache, logits)
    decode_step: Callable      # (cfg, params, cache, tokens, rules) -> (cache, logits)
    cache_defs: Callable       # (cfg, batch, max_len, dtype) -> declarations
    init_cache: Callable       # (cfg, batch, max_len, dtype, rules, device)

    def init(self, cfg: ModelConfig, generator: torch.Generator,
             dtype: torch.dtype = torch.float32, device=None) -> ParamTree:
        """Parameters drawn from ``generator`` on ``device`` (default: the
        card; raises without one).  The generator must live on the same
        device type: ``torch.Generator(device=device)``."""
        return init_params(self.param_defs(cfg), generator, dtype, device)


def _lm_forward(cfg, params, batch, rules=None):
    return lm.forward(cfg, params, batch["tokens"], batch.get("patches"),
                      rules=rules)


def _lm_prefill(cfg, params, inputs, max_len, rules=None):
    return lm.prefill(cfg, params, inputs["tokens"], max_len,
                      inputs.get("patches"), rules=rules)


_LM = Model(
    param_defs=lm.param_defs,
    forward=_lm_forward,
    loss=lm.loss_fn,
    prefill=_lm_prefill,
    decode_step=lm.decode_step,
    cache_defs=lm.cache_defs,
    init_cache=lm.init_cache,
)


def get_model(cfg: ModelConfig) -> Model:
    check_ported(cfg)
    if cfg.family == "encdec":
        raise lm.not_ported("the 'encdec' family", "A13f (models/encdec.py)")
    if cfg.family in ("dense", "moe", "hybrid_ssm", "xlstm"):
        return _LM
    raise ValueError(f"unknown family {cfg.family!r}")
