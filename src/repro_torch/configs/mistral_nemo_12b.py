"""mistral-nemo-12b — dense GQA, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407; hf] 40 layers, d_model=5120,
32 heads with explicit head_dim=128 (32×128=4096 ≠ 5120 by design),
GQA kv=8, d_ff=14336, vocab=131072, rope_theta=1e6 for 128k context.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Nemo-Base-2407 (hf tier)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemo-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=24,  # head_dim ≠ d/h, like nemo
        d_ff=128, vocab_size=256, rope_theta=1e4)
