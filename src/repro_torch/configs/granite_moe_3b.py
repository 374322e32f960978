"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf] 32 layers, d_model=1536,
24 heads (GQA kv=8, head_dim=64), expert d_ff=512, vocab=49155,
40 experts top-8 (the structured config line supersedes the free-text
"32 experts" — DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (hf tier)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
        n_experts=8, top_k=4, tie_embeddings=True, rope_theta=1e4)
