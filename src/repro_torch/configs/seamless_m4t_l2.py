"""seamless-m4t-large-v2 — speech-encoder / text-decoder (enc-dec).

[arXiv:2308.11596; hf] 24 encoder + 24 decoder layers, d_model=1024,
16 heads (MHA: kv=16, head_dim=64), d_ff=8192, vocab=256206. The audio
frontend is a STUB per the brief: ``input_specs()`` provides precomputed
80-dim filterbank frames; a linear adapter embeds them (DESIGN.md §5).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    modality="audio",
    n_layers=24,          # decoder layers
    enc_layers=24,        # speech-encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    frontend="fbank",
    frontend_dim=80,
    frontend_len=4096,    # encoder frames for decode-shape serving
    rope_theta=10_000.0,
    source="arXiv:2308.11596 (hf tier)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="encdec", modality="audio",
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, frontend="fbank",
        frontend_dim=20, frontend_len=32, rope_theta=1e4)
