"""Paged decode attention (the plan's ``decode_attn``).

``paged_decode_attention`` launches ``csrc/paged_attention.cu`` on a CUDA
tensor and runs ``ref.paged_decode_attention`` on a CPU tensor.
``paged_decode_attention.launches`` counts kernel launches.  The verify
window kernel and the quantized twins come with their slices.  The CUDA
kernel covers what the main paths run (no sliding window, head dim 64 for
gpt2 or 128 for llama3); on the card the rest is refused until a slice
whose config needs it adds it.  The plain version covers it all.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path

HEAD_DIMS = (64, 128)     # the CUDA kernel's head dims
MAX_GROUP = 8             # query heads per KV head the kernel holds


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("paged_attention")
    sym = ("repro_paged_decode_bf16" if dtype == torch.bfloat16
           else "repro_paged_decode_f32")
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                                     i, ctypes.c_float, vp])


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q [B, 1, Hq, D]; pools [P, ps, Hkv, D]; page_table [B, maxp] int32
    (valid page ids, NULL page 0 where unallocated); lengths [B] int32
    valid entries per slot -> [B, 1, Hq, D].  Length 0 gives zeros."""
    b, one, hq, d = q.shape
    _, ps, hkv, d2 = k_pool.shape
    maxp = page_table.shape[1]
    if (one != 1 or d != d2 or tuple(v_pool.shape) != tuple(k_pool.shape)
            or hq % hkv or page_table.shape[0] != b
            or tuple(lengths.shape) != (b,)):
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}, table "
                         f"{tuple(page_table.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kernel_path(q) == "plain":
        return ref.paged_decode_attention(q, k_pool, v_pool, page_table,
                                          lengths, window=window,
                                          scale=scale)
    check_cuda_operands("paged_decode_attention", q.dtype, q, k_pool, v_pool,
                        page_table, lengths)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q and pools must share a "
                        "dtype")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: page_table and lengths "
                        "must be int32")
    g = hq // hkv
    if d not in HEAD_DIMS or g > MAX_GROUP or window:
        raise ValueError("paged_decode_attention: the CUDA kernel runs head "
                         f"dims {HEAD_DIMS}, groups up to {MAX_GROUP}, no "
                         f"window; got head dim {d}, group {g}, window "
                         f"{window}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry(q.dtype)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, hkv, g,
        d, ps, maxp, float(scale), stream)
    check_launch("paged_decode_attention", status)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
