"""Model-layout wrappers over the flattened-head kernels.

The reference pads the head dim to the TPU's 128 lanes here
(``repro/kernels/ops.py:62``); the Hopper kernels take the head dim as it
is, so no padding is done.  The RWKV6 recurrence ``wkv6`` (K14) already
takes the model layout and is re-exported here, as the reference's
``ops.py:24`` re-exports ``wkv6_pallas``; so is the layout converter
``convert_layout`` (K15), as the reference's ``ops.py:25``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .flash_attention import flash_attention_2d, flash_attention_2d_q
from .ref import code_view
from .rwkv6_wkv import wkv6  # noqa: F401  (re-export)
from .stream_converter import convert_layout  # noqa: F401  (re-export)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_offset: Optional[int] = None,
                    kv_len: Optional[int] = None,
                    causal: bool = True, window: int = 0,
                    block_kv: int = 512,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Model-layout flash attention with GQA: the offset (chunked-prefill)
    branch when ``q_offset`` is given, else the static one.

    q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D].  Query heads
    are flattened kv-head-major, so flattened head ``b`` reads KV head
    ``b // G`` without repeating K/V in memory.  Quantized K/V (offset
    branch only): k/v are codes and ``k_scale``/``v_scale`` [B, Skv, Hkv]
    their float32 per-position scales (``ops.py:37`` of the reference)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qk = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4) \
        .reshape(b * hkv * g, sq, d).contiguous()
    # Through the bytes for fp8 codes, whose copies need not exist on
    # every device.
    kk = code_view(k).permute(0, 2, 1, 3).reshape(b * hkv, skv, d) \
        .contiguous().view(k.dtype)
    vk = code_view(v).permute(0, 2, 1, 3).reshape(b * hkv, skv, d) \
        .contiguous().view(v.dtype)
    kw = dict(q_offset=q_offset, kv_len=kv_len, causal=causal,
              window=window, scale=1.0 / math.sqrt(d), kv_group=g,
              block_kv=block_kv)
    if k_scale is None:
        out = flash_attention_2d(qk, kk, vk, **kw)
    else:
        if q_offset is None:
            raise ValueError("quantized flash attention runs the offset "
                             "(chunked-prefill) branch only")
        ks = k_scale.permute(0, 2, 1).reshape(b * hkv, skv).contiguous()
        vs = v_scale.permute(0, 2, 1).reshape(b * hkv, skv).contiguous()
        out = flash_attention_2d_q(qk, kk, vk, k_scale=ks, v_scale=vs, **kw)
    return out.reshape(b, hkv, g, sq, d).permute(0, 3, 1, 2, 4) \
        .reshape(b, sq, hq, d)
