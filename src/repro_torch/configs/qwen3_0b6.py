"""qwen3-0.6b — dense GQA with QK-norm. [hf:Qwen/Qwen3-8B family; hf]

28 layers, d_model=1024, 16 heads (GQA kv=8) with explicit head_dim=128
(16×128=2048 ≠ 1024, Qwen3 decouples head width), d_ff=3072,
vocab=151936, per-head RMS QK-norm, tied embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B config family (hf tier)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=256,
        qk_norm=True, tie_embeddings=True, rope_theta=1e4)
