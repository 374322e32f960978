"""internvl2-76b — InternViT frontend + InternLM2/Llama3-70B-class LLM.

[arXiv:2404.16821; unverified] 80-layer dense decoder, d_model=8192,
64 heads (GQA kv=8, head_dim=128), d_ff=28672, vocab=128256. The
InternViT frontend is a STUB per the brief: ``input_specs()`` provides
precomputed patch embeddings (B, 256, 3200); a linear adapter projects
them to d_model and they are prepended to the token sequence.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="dense",
    modality="vision",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    frontend="patch",
    frontend_dim=3200,    # InternViT-6B output width
    frontend_len=256,     # patch tokens per image
    rope_theta=5e5,
    source="arXiv:2404.16821 (unverified tier)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl-smoke", family="dense", modality="vision",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, frontend="patch", frontend_dim=48,
        frontend_len=8, rope_theta=1e4)
