"""Architecture configuration dataclass (copy of ``repro.configs.base``).

Only what the port's slices read is kept: the ``ModelConfig`` fields, the
derived head/width accessors, the layer-pattern helpers and ``reduced()``,
and ``ShapeConfig`` (``configs/base.py:250``), the training batch shape.
Field names and defaults match the reference so a config converts between
the two packages field by field.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

DENSE, MOE, HYBRID, SSM, VLM, AUDIO = (
    "dense", "moe", "hybrid", "ssm", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    """Config for every architecture family of the reference registry."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    activation: str = "silu"          # silu | gelu
    gated_ffn: bool = True            # SwiGLU/GeGLU (3 mats) vs MLP (2 mats)
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    qkv_bias: bool = False
    qk_norm: bool = False
    rope: str = "rope"                # rope | mrope | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    encoder_only: bool = False
    causal: bool = True
    sliding_window: int = 0           # 0 = full attention
    global_attn_every: int = 0        # k: every k-th layer is global
    num_experts: int = 0
    top_k: int = 0
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    shared_attn_every: int = 0
    rwkv: bool = False
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 0
    remat_attn_chunk: bool = False
    # Dispatch the model's stages to the kernels the StreamPlan selects
    # instead of the eager PyTorch path.
    use_fused_kernels: bool = False
    kv_cache_layout: str = "bshd"
    frontend: str = "none"            # none | patch | frame
    dtype: str = "bfloat16"
    quant: str = "none"               # none | kv_int8 | kv_fp8 | w8 | w8_kv8
    max_seq_len: int = 524_288

    QUANT_MODES = ("none", "kv_int8", "kv_fp8", "w8", "w8_kv8")

    def __post_init__(self):
        if self.quant not in self.QUANT_MODES:
            raise ValueError(
                f"unknown quant mode {self.quant!r}: one of "
                f"{self.QUANT_MODES}")

    @property
    def kv_quant(self) -> Optional[str]:
        """KV-pool storage format ("int8" | "fp8" | None)."""
        if self.quant in ("kv_int8", "w8_kv8"):
            return "int8"
        if self.quant == "kv_fp8":
            return "fp8"
        return None

    @property
    def weight_quant(self) -> bool:
        """Weight-only int8 on the plan's matmul stages."""
        return self.quant in ("w8", "w8_kv8")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.num_heads))

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim_

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_mamba(self) -> bool:
        return self.ssm_state > 0

    def layer_kind(self, i: int) -> str:
        """What block sits at layer ``i`` (pattern-aware)."""
        if self.rwkv:
            return "rwkv"
        if self.is_mamba:
            if (self.shared_attn_every
                    and (i + 1) % self.shared_attn_every == 0):
                return "mamba+shared_attn"
            return "mamba"
        if self.global_attn_every:
            return ("global_attn"
                    if (i + 1) % self.global_attn_every == 0
                    else "local_attn")
        return "attn"

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """One repeating group of layer kinds."""
        period = (self.shared_attn_every or self.global_attn_every or 1)
        return tuple(self.layer_kind(i) for i in range(period))

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU tests (same rule as the
        reference, so ``reduced()`` names the same shapes in both)."""
        return replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(2, min(4, (self.shared_attn_every
                                      or self.global_attn_every or 1) * 2)),
            d_model=64,
            num_heads=4,
            num_kv_heads=2 if self.num_kv_heads < self.num_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=4 if self.is_moe else 0,
            top_k=2 if self.is_moe else 0,
            ssm_state=16 if self.is_mamba else 0,
            ssm_head_dim=32,
            rwkv_head_dim=16,
            sliding_window=32 if self.sliding_window else 0,
            global_attn_every=2 if self.global_attn_every else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            max_seq_len=512,
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: sequence length, global batch and kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"
