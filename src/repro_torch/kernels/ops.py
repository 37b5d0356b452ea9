"""Model-layout wrappers over the flattened-head kernels.

The reference pads the head dim to the TPU's 128 lanes here
(``repro/kernels/ops.py:62``); the Hopper kernels take the head dim as it
is, so no padding is done.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention_2d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: Optional[int] = None,
                    kv_len: Optional[int] = None,
                    causal: bool = True, window: int = 0,
                    block_kv: int = 512) -> torch.Tensor:
    """Model-layout flash attention with GQA: the offset (chunked-prefill)
    branch when ``q_offset`` is given, else the static one.

    q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D].  Query heads
    are flattened kv-head-major, so flattened head ``b`` reads KV head
    ``b // G`` without repeating K/V in memory."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qk = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4) \
        .reshape(b * hkv * g, sq, d).contiguous()
    kk = k.permute(0, 2, 1, 3).reshape(b * hkv, skv, d).contiguous()
    vk = v.permute(0, 2, 1, 3).reshape(b * hkv, skv, d).contiguous()
    out = flash_attention_2d(qk, kk, vk, q_offset=q_offset, kv_len=kv_len,
                             causal=causal, window=window,
                             scale=1.0 / math.sqrt(d), kv_group=g,
                             block_kv=block_kv)
    return out.reshape(b, hkv, g, sq, d).permute(0, 3, 1, 2, 4) \
        .reshape(b, sq, hq, d)
