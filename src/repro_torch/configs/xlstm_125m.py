"""xlstm-125m — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

12 layers, d_model=768, 4 heads, vocab=50304, d_ff=0: feed-forward capacity
lives inside the LSTM blocks (mLSTM up-projection factor 2, sLSTM
gated-MLP factor 4/3, per the xLSTM paper). One sLSTM block every 4th
layer (positions 3, 7, 11), the rest mLSTM.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="xlstm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    slstm_every=4,
    mlstm_proj=2.0,
    slstm_proj=4.0 / 3.0,
    source="arXiv:2405.04517 (unverified tier)",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="xlstm", n_layers=4, d_model=64,
        n_heads=2, n_kv_heads=2, head_dim=32, d_ff=0, vocab_size=256,
        slstm_every=2, mlstm_proj=2.0, slstm_proj=4.0 / 3.0)
