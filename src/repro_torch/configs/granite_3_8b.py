"""granite-3-8b — dense GQA. [hf:ibm-granite/granite-3.0-2b-base family; hf]

40 layers, d_model=4096, 32 heads (GQA kv=8, head_dim=128), d_ff=12800,
vocab=49155.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-2b-base config family (hf tier)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite3-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        rope_theta=1e4)
