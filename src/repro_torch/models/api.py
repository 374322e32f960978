"""Unified model API: one ``Model`` namespace per config, dispatched on
family.  Port of ``repro.models.api``.

  model = get_model(cfg)
  params = model.init(cfg, generator, device=device)
  logits, aux = model.forward(cfg, params, batch)
  loss, metrics = model.loss(cfg, params, batch)     # lm.loss_fn
  cache, logits = model.prefill(cfg, params, inputs, max_len)
  cache, logits = model.decode_step(cfg, params, cache, tokens)

The families other than ``dense`` and ``moe`` raise
``NotImplementedError`` naming their ROADMAP items (A13d-f).  Over a
device mesh every entry takes ``rules`` (``sharding.MeshRules``), and
``Model.init(rules=...)`` gives this rank its blocks; ``shardings`` and
``specs`` give the parameters' layout.  The dry-run's sharded stand-ins
(``structs``, ``cache_structs``, ``input_specs``) are ROADMAP A13g.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig
from . import lm
from .params import (ParamTree, init_params, param_shardings, param_specs,
                     param_structs)


class Model(NamedTuple):
    param_defs: Callable
    forward: Callable          # (cfg, params, batch, rules) -> (logits, aux)
    loss: Callable             # (cfg, params, batch, rules) -> (loss, metrics)
    prefill: Callable          # (cfg, params, inputs, max_len, rules) -> (cache, logits)
    decode_step: Callable      # (cfg, params, cache, tokens, rules) -> (cache, logits)
    cache_defs: Callable       # (cfg, batch, max_len, dtype) -> declarations
    init_cache: Callable       # (cfg, batch, max_len, dtype, rules, device)
    cache_structs: Callable    # ROADMAP A13g

    def init(self, cfg: ModelConfig, generator: torch.Generator,
             dtype: torch.dtype = torch.float32, device=None,
             requires_grad: bool = False, rules=None) -> ParamTree:
        """Parameters drawn from ``generator`` on ``device`` (default: the
        card; raises without one).  The generator must live on the same
        device type: ``torch.Generator(device=device)``.
        ``requires_grad=True``: a trainable tree.  ``rules``: this rank's
        blocks of the same draws."""
        return init_params(self.param_defs(cfg), generator, dtype, device,
                           requires_grad, rules=rules)

    def shardings(self, cfg: ModelConfig, rules):
        return param_shardings(self.param_defs(cfg), rules)

    def specs(self, cfg: ModelConfig, rules):
        return param_specs(self.param_defs(cfg), rules)

    def structs(self, cfg: ModelConfig, rules=None, dtype=torch.float32):
        return param_structs(self.param_defs(cfg), rules, dtype)


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
    cache_structs=lm.cache_structs,
)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family == "encdec":
        raise lm.not_ported("the 'encdec' family", "A13f (models/encdec.py)")
    if cfg.family in ("dense", "moe", "hybrid_ssm", "xlstm"):
        return _LM
    raise ValueError(f"unknown family {cfg.family!r}")


def input_specs(*args, **kwargs):
    """The dry-run's input stand-ins: ROADMAP A13g."""
    raise lm.not_ported("input_specs (the dry-run's input stand-ins)",
                        "A13g")
