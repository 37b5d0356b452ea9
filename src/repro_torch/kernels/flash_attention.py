"""Flash attention: the offset branch for chunked prefill and the static
branch for whole-prompt prefill (the plan's ``attention``).

``flash_attention_2d`` takes the offset branch when ``q_offset`` is given
and the static branch (``flash_attention_static``) when it is None, as the
reference wrapper does.  Each launches its entry point in
``csrc/flash_attention.cu`` on a CUDA tensor and runs its plain version
(``ref.flash_attention_offset`` / ``ref.flash_attention_static``) on a CPU
tensor; ``flash_attention_2d.launches`` counts offset launches and
``flash_attention_static.launches`` static ones.  The CUDA kernel covers
what the main paths run (causal, no sliding window, head dim 64 or 128);
on the card the rest is refused until a slice whose config needs it adds
it.  The plain versions cover it all.
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


@functools.lru_cache(maxsize=None)
def _entry(branch: str, dtype: torch.dtype):
    """``branch``: "offset" or "static"."""
    lib = _build.load("flash_attention")
    sym = (f"repro_flash_{branch}_"
           + ("bf16" if dtype == torch.bfloat16 else "f32"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    ints = [i] * (7 if branch == "offset" else 6)
    return _build.declare(lib, sym, [vp] * 4 + ints + [ctypes.c_float, vp])


def _check(name: str, q, k, v, kv_group: int) -> None:
    h, _, d = q.shape
    hk, _, d2 = k.shape
    if d != d2 or tuple(v.shape) != tuple(k.shape) or h != hk * kv_group:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, kv_group {kv_group}")


def _check_cuda(name: str, q, k, v, causal: bool, window: int) -> None:
    check_cuda_operands(name, q.dtype, q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    d = q.shape[-1]
    if d not in HEAD_DIMS or not causal or window:
        raise ValueError(f"{name}: the CUDA kernel runs causal attention "
                         f"without a window at head dims {HEAD_DIMS}; got "
                         f"head dim {d}, causal {causal}, window {window}")


def flash_attention_2d(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, q_offset: Optional[int] = None,
                       kv_len: Optional[int] = None, causal: bool = True,
                       window: int = 0, scale: Optional[float] = None,
                       kv_group: int = 1,
                       block_kv: int = 512) -> torch.Tensor:
    """Flattened-head core: q [Hq_, Sq, D], k/v [Hkv_, Skv, D] with
    ``Hq_ == Hkv_ * kv_group`` -> [Hq_, Sq, D].

    Query i sits at absolute position ``q_offset + i`` (``q_offset`` None:
    the static branch, position i); positions at or past ``kv_len``
    (default Skv) are masked.  ``block_kv`` is the plan's hint: the plain
    versions walk KV tiles of that size as the reference kernel does; the
    CUDA kernel picks its own tiles."""
    if q_offset is None:
        return flash_attention_static(q, k, v, kv_len=kv_len, causal=causal,
                                      window=window, scale=scale,
                                      kv_group=kv_group, block_kv=block_kv)
    _check("flash_attention_2d", q, k, v, kv_group)
    h, sq, d = q.shape
    skv = k.shape[1]
    kv_len = skv if kv_len is None else int(kv_len)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kernel_path(q) == "plain":
        return ref.flash_attention_offset(
            q, k, v, q_offset=int(q_offset), kv_len=kv_len,
            kv_group=kv_group, scale=scale, causal=causal, window=window,
            block_kv=block_kv)
    _check_cuda("flash_attention_2d", q, k, v, causal, window)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry("offset", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), h, sq, skv,
        d, kv_group, int(q_offset), kv_len, float(scale), stream)
    check_launch("flash_attention_2d", status)
    flash_attention_2d.launches += 1
    return out


def flash_attention_static(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, kv_len: Optional[int] = None,
                           causal: bool = True, window: int = 0,
                           scale: Optional[float] = None, kv_group: int = 1,
                           block_kv: int = 512) -> torch.Tensor:
    """The static branch of ``flash_attention_2d``: full-sequence attention,
    query i at position i, keys at or past ``kv_len`` (default Skv)
    masked.  Any Sq and Skv: the CUDA kernel assumes no tile divides
    them."""
    _check("flash_attention_static", q, k, v, kv_group)
    h, sq, d = q.shape
    skv = k.shape[1]
    kv_len = skv if kv_len is None else int(kv_len)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kernel_path(q) == "plain":
        return ref.flash_attention_static(
            q, k, v, kv_len=kv_len, kv_group=kv_group, scale=scale,
            causal=causal, window=window, block_kv=block_kv)
    _check_cuda("flash_attention_static", q, k, v, causal, window)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry("static", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), h, sq, skv,
        d, kv_group, kv_len, float(scale), stream)
    check_launch("flash_attention_static", status)
    flash_attention_static.launches += 1
    return out


flash_attention_2d.launches = 0
flash_attention_static.launches = 0
