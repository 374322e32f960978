"""zamba2-7b — Mamba2 backbone + one shared attention+MLP block.

[arXiv:2411.15242; unverified] 81 Mamba2 layers, d_model=3584; the single
shared full-attention+MLP block (Zamba weight-sharing scheme) is invoked
after every 6th Mamba2 layer. 32 heads (MHA: kv=32, head_dim=112),
d_ff=14336 for the shared MLP, vocab=32000, ssm_state=64.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid_ssm",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
    rope_theta=10_000.0,
    source="arXiv:2411.15242 (unverified tier)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid_ssm", n_layers=7, d_model=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
        attn_every=3, rope_theta=10_000.0)
