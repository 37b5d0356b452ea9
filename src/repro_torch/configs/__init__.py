"""Architecture registry of the port.

Holds the configurations the port can serve so far; the other reference
architectures join with their slices.
"""

from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from .gpt2 import CONFIG as GPT2
from .granite_moe_1b import CONFIG as GRANITE_MOE_1B
from .granite_moe_3b import CONFIG as GRANITE_MOE_3B
from .llama3_8b import CONFIG as LLAMA3_8B

ARCHS: Dict[str, ModelConfig] = {
    "gpt2": GPT2,
    "granite-moe-1b-a400m": GRANITE_MOE_1B,
    "granite-moe-3b-a800m": GRANITE_MOE_3B,
    "llama3-8b": LLAMA3_8B,
}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")


__all__ = ["ARCHS", "ModelConfig", "get_config"]
