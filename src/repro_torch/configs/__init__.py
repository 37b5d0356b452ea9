"""Architecture registry of the port: ``--arch <id>`` resolution and the
dry-run's cell matrix (``repro/configs/__init__.py``).

``ARCHS`` holds the eleven registry configs; ``ASSIGNED_ARCHS`` the ten
dry-run archs in the reference's order (gpt2, the paper's own model, is
a benchmark, not a dry-run cell); ``cells()`` enumerates every runnable
(arch x shape) cell and ``skipped_cells()`` the skips with their reasons.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, TRAIN_4K,
                   ModelConfig, ShapeConfig, shapes_for, skipped_shapes_for)
from .gemma3_4b import CONFIG as GEMMA3_4B
from .gpt2 import CONFIG as GPT2
from .gpt2 import PAPER_GEMMA, PAPER_LLAMA, PAPER_QWEN
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

PAPER_MODELS: Dict[str, ModelConfig] = {
    "gpt2": GPT2,
    "paper-qwen": PAPER_QWEN,
    "paper-llama": PAPER_LLAMA,
    "paper-gemma": PAPER_GEMMA,
}

# The reference's registry order (``repro/configs/__init__.py:28``), gpt2
# left out: ``cells()`` walks the archs in this order.
ASSIGNED_ARCHS: Tuple[str, ...] = (
    "zamba2-2.7b", "qwen2-vl-2b", "qwen1.5-0.5b", "gemma3-4b", "qwen3-0.6b",
    "llama3-8b", "granite-moe-1b-a400m", "granite-moe-3b-a800m",
    "hubert-xlarge", "rwkv6-7b")


def get_config(arch: str) -> ModelConfig:
    try:
        return ARCHS[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")


def get_shape(name: str) -> ShapeConfig:
    return ALL_SHAPES[name]


def cells() -> Iterator[Tuple[ModelConfig, ShapeConfig]]:
    """Every runnable (arch x shape) dry-run cell."""
    for arch in ASSIGNED_ARCHS:
        cfg = ARCHS[arch]
        for shape in shapes_for(cfg):
            yield cfg, shape


def skipped_cells() -> Iterator[Tuple[str, str, str]]:
    """(arch, shape, reason) for documented skips."""
    for arch in ASSIGNED_ARCHS:
        cfg = ARCHS[arch]
        for shape, reason in skipped_shapes_for(cfg):
            yield arch, shape, reason


__all__ = [
    "ARCHS", "ASSIGNED_ARCHS", "PAPER_MODELS", "ModelConfig", "ShapeConfig",
    "get_config", "get_shape", "cells", "skipped_cells", "shapes_for",
    "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
