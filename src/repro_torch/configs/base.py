"""Config system: model architectures, input shapes, mesh/runtime knobs.

A plain dataclass copy of ``repro.configs.base``, kept here so that the
port imports nothing of the JAX package; the parity tests hold the two
field for field.  Every architecture is one ``ModelConfig`` in its own
module (``repro_torch/configs/<id>.py``) with the exact dimensions and a
``smoke()`` reduced config of the same family for CPU tests. The shape
registry defines the four input shapes; ``cells()`` enumerates the
(architecture × shape) grid with applicability rules (DESIGN.md §5).

``attn_impl`` keeps the JAX package's values.  In the port ``"pallas"``
selects the hand-written CUDA kernels ``kernels/csrc/flash_attention.cu``
(full-sequence ``common.attention``) and ``decode_attention.cu`` (serving
decode, ``common.attention_decode``), each its plain PyTorch version on
CPU tensors; ``"einsum"`` and ``"blocked"`` are plain PyTorch.
``use_pallas=True`` sends every RMSNorm of the LM path (forward, prefill,
decode) to ``kernels/csrc/rmsnorm.cu`` (its plain version on CPU
tensors); the default ``False`` computes exactly what the JAX package
computes.  ``n_params()`` resolves through the
port's ``models.api``, which declares the dense and MoE families so far.
``fsdp`` and ``moe_impl`` are read by the model on a mesh
(``sharding.MeshRules``, ``models.common.moe_ffn``); ``hier_allreduce``
is read by nothing, in the JAX package as in the port, and is kept for
the field-for-field parity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid_ssm | xlstm | encdec
    modality: str = "text"         # text | audio | vision
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    norm_eps: float = 1e-5
    rope_theta: float = 1e6
    qk_norm: bool = False
    window: Optional[int] = None   # sliding-window attention width
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_impl: str = "shard_map"    # shard_map (per-shard dispatch + psum)
                                   # | gspmd (partitioner-replicated baseline)
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # hybrid (Zamba2): one shared attention+MLP block every `attn_every`
    attn_every: int = 0
    # xLSTM
    slstm_every: int = 0           # sLSTM block period (others are mLSTM)
    mlstm_proj: float = 2.0
    slstm_proj: float = 4.0 / 3.0
    # encoder-decoder
    enc_layers: int = 0
    # modality frontend stub (precomputed features via input_specs())
    frontend: Optional[str] = None  # "fbank" | "patch"
    frontend_dim: int = 0
    frontend_len: int = 0
    # numerics / performance knobs (the hillclimb surface)
    dtype: str = "bfloat16"
    remat: str = "block"           # none | block
    use_pallas: bool = False       # True: the RMSNorm kernel on the LM path
    microbatch: int = 1            # grad-accumulation inside train_step
    logits_fp32: bool = True
    fsdp: bool = False             # shard params over data axis (ZeRO-3-ish)
    hier_allreduce: bool = False   # pod-hierarchical gradient reduction
                                   # (read by nothing, as in the JAX package)
    scan_layers: bool = True       # scan-over-layers (False: unrolled)
    attn_impl: str = "blocked"     # einsum | blocked | pallas (einsum = naive
                                   # baseline; blocked tiles q so 32k prefill
                                   # scores fit HBM; identical when s<=q_block;
                                   # pallas = the CUDA flash-attention kernel)
    q_block: int = 2048            # blocked-attention query tile
    source: str = ""               # provenance note

    # -- derived -------------------------------------------------------------

    def padded_vocab(self, model_shards: int) -> int:
        mult = 128 * model_shards
        return -(-self.vocab_size // mult) * mult

    @property
    def d_inner(self) -> int:      # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Supports 500k-token decode state (DESIGN.md §5): recurrent state
        or bounded sliding-window KV."""
        return (self.family in ("hybrid_ssm", "xlstm")
                or self.window is not None)

    @property
    def layer_pattern_period(self) -> int:
        """Periodicity of the block pattern (for scan grouping and the
        layer-cost accounting in unrolled analyses)."""
        if self.family == "hybrid_ssm" and self.attn_every:
            return self.attn_every
        if self.family == "xlstm" and self.slstm_every:
            return self.slstm_every
        return 1

    def n_params(self) -> int:
        """Exact parameter count from the model's declaration table."""
        from ..models.api import get_model
        from ..models.params import count_params
        return count_params(get_model(self).param_defs(self))

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE experts scaled to top_k/E)."""
        from ..models.api import get_model
        from ..models.params import count_params, map_defs
        import numpy as np
        defs = get_model(self).param_defs(self)
        if not self.is_moe:
            return count_params(defs)
        total = count_params(defs)
        expert = 0
        for key in ("w_gate", "w_up", "w_down"):
            d = defs["layers"]["moe"][key]
            expert += int(np.prod(d.shape))
        return total - expert + expert * self.top_k // self.n_experts


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runs?, reason-if-skip) per DESIGN.md §5."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attention): 512k dense KV has no sub-quadratic path"
    return True, ""
