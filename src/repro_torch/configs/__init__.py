"""Architecture registry of the port.

Holds the configurations the port runs so far (hubert-xlarge, an
encoder, is encoded and trained, not served); the other reference
architectures join with their slices.
"""

from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from .gemma3_4b import CONFIG as GEMMA3_4B
from .gpt2 import CONFIG as GPT2
from .granite_moe_1b import CONFIG as GRANITE_MOE_1B
from .granite_moe_3b import CONFIG as GRANITE_MOE_3B
from .hubert_xlarge import CONFIG as HUBERT_XLARGE
from .llama3_8b import CONFIG as LLAMA3_8B
from .qwen1p5_0p5b import CONFIG as QWEN1P5_0P5B
from .qwen2_vl_2b import CONFIG as QWEN2_VL_2B
from .qwen3_0p6b import CONFIG as QWEN3_0P6B
from .rwkv6_7b import CONFIG as RWKV6_7B
from .zamba2_2p7b import CONFIG as ZAMBA2_2P7B

ARCHS: Dict[str, ModelConfig] = {
    "gemma3-4b": GEMMA3_4B,
    "gpt2": GPT2,
    "granite-moe-1b-a400m": GRANITE_MOE_1B,
    "granite-moe-3b-a800m": GRANITE_MOE_3B,
    "hubert-xlarge": HUBERT_XLARGE,
    "llama3-8b": LLAMA3_8B,
    "qwen1.5-0.5b": QWEN1P5_0P5B,
    "qwen2-vl-2b": QWEN2_VL_2B,
    "qwen3-0.6b": QWEN3_0P6B,
    "rwkv6-7b": RWKV6_7B,
    "zamba2-2.7b": ZAMBA2_2P7B,
}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")


__all__ = ["ARCHS", "ModelConfig", "get_config"]
