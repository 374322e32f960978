"""Smoke serving on the card against the CPU, for the port's dense-family
configs: the check of ``test_torch_cuda.py::test_serving_on_the_card_
equals_the_cpu``, which ``chip_smoke.py`` (phase 20c) runs as well.

Needs a CUDA card; ``serve_on_card_against_cpu`` raises
``AssertionError`` at the first mismatch.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

#: Decode steps, each started on the card from a copy of the CPU's cache
#: (past the smoke configs' windows of 32, so the rings wrap).
STEPS = 48


def serve_on_card_against_cpu(arch: str, device, steps: int = STEPS,
                              forward: bool = False) -> dict:
    """fp32 smoke serving of ``arch`` with both kernel switches on.  The
    prefill, and each of ``steps`` decode steps started on the card from a
    copy of the CPU's cache, give the CPU's logits and cache within the
    model-parity tolerance (rtol 2e-4, atol 2e-4 or 2e-5 of the largest
    logit: fp32 sums in another order on each side); with ``forward``, a
    full-sequence forward too (``flash_attention`` at every layer).  The
    card launches ``decode_attention`` at every layer of every step and
    ``rmsnorm`` at every norm of every pass.  ``ServeEngine`` on the card
    generates the CPU's greedy tokens, but for a patch frontend, whose
    prefill takes its patch embeddings first (``ServeEngine`` passes
    tokens only and refuses it, as the JAX package's does).  -> {"worst":
    max |card - CPU|, "counts": launch counts, "tokens_equal": True, or
    None for a patch frontend}."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model
    from repro_torch.serve import ServeEngine
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              attn_impl="pallas", use_pallas=True)
    model = get_model(cfg)
    cpu = model.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(0)
    worst = [0.0]

    def close(got, want, what):
        atol = max(2e-4, 2e-5 * float(want.float().abs().max()))
        worst[0] = max(worst[0], float((got.cpu().float() - want.float())
                                       .abs().max()))
        try:
            torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=atol)
        except AssertionError as e:
            raise AssertionError(f"{cfg.name} {what}: {e}") from None

    inputs = {"tokens": rng.integers(1, cfg.vocab_size, (3, 40))}
    if cfg.frontend == "patch":
        inputs["patches"] = rng.standard_normal(
            (3, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    ops.reset_launch_counts()
    cache_c, lc = model.prefill(cfg, card, inputs, 128)
    cache_h, lh = model.prefill(cfg, cpu, inputs, 128)
    close(lc, lh, "prefill logits")
    for i in range(steps):
        t = rng.integers(1, cfg.vocab_size, 3)
        cache_c = {k: v.to(device) for k, v in cache_h.items()}
        cache_c, lc = model.decode_step(cfg, card, cache_c, t)
        cache_h, lh = model.decode_step(cfg, cpu, cache_h, t)
        close(lc, lh, f"step {i} logits")
        for k in cache_h:
            close(cache_c[k], cache_h[k], f"step {i} cache {k}")
    if forward:
        with torch.no_grad():
            fc, _ = model.forward(cfg, card, inputs)
            fh, _ = model.forward(cfg, cpu, inputs)
        close(fc, fh, "forward logits")
    counts = ops.launch_counts()
    norms = cfg.n_layers * (2 + 2 * cfg.qk_norm) + 1
    assert counts["decode_attention"] == steps * cfg.n_layers, counts
    assert counts["rmsnorm"] == (1 + steps + forward) * norms, counts
    if forward:
        assert counts["flash_attention"] == cfg.n_layers, counts
    same = None
    if cfg.frontend != "patch":
        prompts = [list(range(1, 30)), [5, 6, 7], list(range(9, 20))]
        got = ServeEngine(cfg, card, max_len=128).generate(prompts, 12)
        want = ServeEngine(cfg, cpu, max_len=128).generate(prompts, 12)
        same = got.tokens == want.tokens
        assert same, f"{cfg.name}: ServeEngine's greedy tokens differ"
    return {"worst": worst[0], "counts": counts, "tokens_equal": same}
