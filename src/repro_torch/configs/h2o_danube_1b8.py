"""h2o-danube-1.8b — llama/mistral-mix dense model with sliding window.

[arXiv:2401.16818; hf] 24 layers, d_model=2560, 32 heads (GQA kv=8,
head_dim=80), d_ff=6912, vocab=32000, sliding-window attention
(trained with window 4096 per the H2O-Danube report).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    window=4096,
    rope_theta=10_000.0,
    source="arXiv:2401.16818 (hf tier)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        window=32, rope_theta=1e4)
