"""Architecture registry of the port.

Holds the configurations the port can serve so far; the other reference
architectures join with their slices.
"""

from __future__ import annotations

from typing import Dict

from .base import ModelConfig
from .gpt2 import CONFIG as GPT2
from .llama3_8b import CONFIG as LLAMA3_8B

ARCHS: Dict[str, ModelConfig] = {
    "gpt2": GPT2,
    "llama3-8b": LLAMA3_8B,
}


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")


__all__ = ["ARCHS", "ModelConfig", "get_config"]
