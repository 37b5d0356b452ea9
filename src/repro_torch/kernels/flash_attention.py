"""Offset flash attention for chunked prefill (the plan's ``attention``).

``flash_attention_2d`` launches ``csrc/flash_attention.cu`` on a CUDA tensor
and runs ``ref.flash_attention_offset`` on a CPU tensor.
``flash_attention_2d.launches`` counts kernel launches.  Only the offset
branch is ported; the static full-sequence kernel (whole-prompt prefill,
training) comes with the gpt2 slice.  The CUDA kernel covers what the
llama3 main path runs (causal, no sliding window, head dim 128); on the
card the rest is refused until a slice whose config needs it adds it.  The
plain version covers it all.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path

HEAD_DIM = 128            # the CUDA kernel's head dim


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("flash_attention")
    sym = ("repro_flash_offset_bf16" if dtype == torch.bfloat16
           else "repro_flash_offset_f32")
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp, vp, vp, vp, i, i, i, i, i, i, i,
                                     ctypes.c_float, vp])


def flash_attention_2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, q_offset: int, kv_len: Optional[int] = None,
                       causal: bool = True, window: int = 0,
                       scale: Optional[float] = None, kv_group: int = 1,
                       block_kv: int = 512) -> torch.Tensor:
    """Flattened-head core: q [Hq_, Sq, D], k/v [Hkv_, Skv, D] with
    ``Hq_ == Hkv_ * kv_group`` -> [Hq_, Sq, D].

    Query i sits at absolute position ``q_offset + i``; positions at or
    past ``kv_len`` (default Skv) are masked.  ``block_kv`` is the plan's
    hint: the plain version walks KV tiles of that size as the reference
    kernel does; the CUDA kernel picks its own tiles."""
    h, sq, d = q.shape
    hk, skv, d2 = k.shape
    kv_len = skv if kv_len is None else int(kv_len)
    if (d != d2 or tuple(v.shape) != tuple(k.shape)
            or h != hk * kv_group):
        raise ValueError(f"flash_attention_2d: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"kv_group {kv_group}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kernel_path(q) == "plain":
        return ref.flash_attention_offset(
            q, k, v, q_offset=int(q_offset), kv_len=kv_len,
            kv_group=kv_group, scale=scale, causal=causal, window=window,
            block_kv=block_kv)
    check_cuda_operands("flash_attention_2d", q.dtype, q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_2d: q, k and v must share a dtype")
    if d != HEAD_DIM or not causal or window:
        raise ValueError("flash_attention_2d: the CUDA kernel runs causal "
                         f"attention without a window at head dim {HEAD_DIM};"
                         f" got head dim {d}, causal {causal}, window "
                         f"{window}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), h, sq, skv,
        d, kv_group, int(q_offset), kv_len, float(scale), stream)
    check_launch("flash_attention_2d", status)
    flash_attention_2d.launches += 1
    return out


flash_attention_2d.launches = 0
