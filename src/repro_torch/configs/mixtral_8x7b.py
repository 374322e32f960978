"""mixtral-8x7b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf] 32 layers, d_model=4096, 32 heads (GQA kv=8,
head_dim=128), expert d_ff=14336, vocab=32000, SWA window 4096.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    window=4096,
    rope_theta=1e6,
    source="arXiv:2401.04088 (hf tier)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        n_experts=4, top_k=2, window=32, rope_theta=1e4)
