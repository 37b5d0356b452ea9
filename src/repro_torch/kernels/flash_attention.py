"""Flash attention: the offset branch for chunked prefill, its twin over
quantized K/V, and the static branch for whole-prompt prefill (the plan's
``attention``).

``flash_attention_2d`` takes the offset branch when ``q_offset`` is given
and the static branch (``flash_attention_static``) when it is None, as the
reference wrapper does.  Each launches its entry point on a CUDA tensor
and runs its plain version (``ref.flash_attention_offset`` /
``ref.flash_attention_static``) on a CPU tensor;
``flash_attention_2d.launches`` counts offset launches and
``flash_attention_static.launches`` static ones.
``flash_attention_2d_q`` is the offset branch over int8 / fp8-e4m3 codes
with per-position scales (its own entry points and count; plain version
``ref.flash_attention_offset`` with scales).  Every branch in bfloat16
runs on the tensor cores (one device function, ``csrc/flash_mma.cu``, the
codes converted to bf16 in shared memory); in float32 every branch runs
the CUDA-core kernel of ``csrc/flash_attention.cu``.  The CUDA kernels cover
what the main paths run: causal attention with or without a sliding
window (gemma3's local layers) at head dim 64, 128 or 320 (gemma3), and
for the static branch also 80 for zamba2's shared block and non-causal
attention without a window (hubert's encoder); over codes (K9c) causal,
with or without a window, head dim 64, 128 or 320.  On the card the rest
is refused until a slice whose config needs it adds it.  The plain
versions cover it all.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build, ref
from .common import (CODE_DTYPES, aligned16, check_cuda_operands,
                     check_launch, kernel_path)

HEAD_DIMS = (64, 128, 320)     # the CUDA kernel's head dims (offset branch)
STATIC_HEAD_DIMS = (64, 80, 128, 320)    # ... the static branch's (K7)
CODE_HEAD_DIMS = (64, 128, 320)    # ... the offset branch's over codes (K9c)
BRANCH_HEAD_DIMS = {"offset": HEAD_DIMS, "static": STATIC_HEAD_DIMS,
                    "offset_q": CODE_HEAD_DIMS}
# The code types' template names in csrc/flash_mma.cu's instances.
_CODE_NAMES = {torch.int8: "signed char",
               torch.float8_e4m3fn: "__nv_fp8_e4m3"}


def cuda_refusal(branch: str, d: int, causal: bool = True,
                 window: int = 0) -> Optional[str]:
    """Why the CUDA build refuses a case of ``branch`` ("offset",
    "static" or "offset_q"), or None when it runs it: head dims
    ``BRANCH_HEAD_DIMS[branch]``, causal with or without a window, and
    for the static branch non-causal without one.  The wrapper raises
    with it; the static checks report it (``analysis/kernel_lint.py``)."""
    dims = BRANCH_HEAD_DIMS[branch]
    non_causal = branch == "static"
    if (d not in dims or window < 0
            or (not causal and (not non_causal or window))):
        return ("the CUDA kernel runs causal attention with or without a "
                "window"
                + (", or non-causal attention without one,"
                   if non_causal else "")
                + f" at head dims {dims}; got head dim {d}, causal "
                f"{causal}, window {window}")
    return None


def smem_bytes(d: int, dtype: torch.dtype,
               code: Optional[torch.dtype] = None) -> dict:
    """{kernel: shared memory per block} of a launch at head dim ``d``
    (``code``: the K/V code type of the offset branch over codes, K9c).
    bf16 (``csrc/flash_mma.cu``, ``smem_bytes<D, C>``): the Q tile and
    two stages of K and V tiles, rows of D + 8 bf16; over codes the key
    groups' converted bf16 tiles, two stages of every group's codes and
    scales.  float32 (``csrc/flash_attention.cu``): the Q tile, the K
    tile at a D + 1 stride and the V tile.  No static arrays; a windowed
    K9c launch has its own instance name with the same bytes."""
    ld = d + 8
    if dtype == torch.bfloat16:
        if code is None:
            return {f"flash_mma_kernel<{d}>": (64 + 4 * 64) * ld * 2}
        groups = 2 if d <= 128 else 1
        nbytes = ((64 + 2 * groups * 64) * ld * 2 + 4 * groups * 64 * d
                  + 4 * groups * 64 * 4)
        name = _CODE_NAMES[code]
        return {f"flash_mma_q_kernel<{d}, {name}>": nbytes,
                f"flash_mma_q_window_kernel<{d}, {name}>": nbytes}
    c = "float" if code is None else _CODE_NAMES[code]
    return {f"flash_offset_kernel<float, {c}, {d}>":
            4 * (16 * d + 32 * (d + 1) + 32 * d)}


@functools.lru_cache(maxsize=None)
def _entry(branch: str, dtype: torch.dtype, code: str = ""):
    """``branch``: "offset", "static" or "offset_q" (``code`` "i8" or
    "fp8").  bf16 is the tensor-core kernel of ``csrc/flash_mma.cu``,
    float32 the CUDA-core device function of ``csrc/flash_attention.cu``."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    # (hq, sq, skv, d, kv_group[, q_offset], kv_len, window[, causal]):
    # the static branch alone takes causal (0: non-causal).
    ints = [i] * 8
    ptrs = 6 if branch == "offset_q" else 4
    suffix = f"_{code}" if code else ""
    if dtype == torch.bfloat16:
        lib = _build.load("flash_mma")
        sym = f"repro_flash_{branch}_mma_bf16{suffix}"
    else:
        lib = _build.load("flash_attention")
        sym = f"repro_flash_{branch}_f32{suffix}"
    return _build.declare(lib, sym, [vp] * ptrs + ints + [ctypes.c_float, vp])


def _check(name: str, q, k, v, kv_group: int) -> None:
    h, _, d = q.shape
    hk, _, d2 = k.shape
    if d != d2 or tuple(v.shape) != tuple(k.shape) or h != hk * kv_group:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, kv_group {kv_group}")


def _check_cuda(name: str, q, k, v, causal: bool, window: int,
                code: Optional[torch.dtype] = None, scales=(),
                branch: str = "offset") -> None:
    """``code``: the K/V dtype, q's unless K/V hold codes (with their
    ``scales``); ``branch``: the entry point's (``cuda_refusal``)."""
    check_cuda_operands(name, q.dtype, q, k, v, *scales)
    code = q.dtype if code is None else code
    if k.dtype != code or v.dtype != code:
        raise TypeError(f"{name}: k and v must be {code}; got {k.dtype}, "
                        f"{v.dtype}")
    why = cuda_refusal(branch, q.shape[-1], causal, window)
    if why is not None:
        raise ValueError(f"{name}: {why}")


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
    (default Skv) are masked; with ``window`` > 0 a key is live only
    above ``position - window``.  ``block_kv`` is the plan's hint: the plain
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
    if q.dtype == torch.bfloat16:
        q, k, v = aligned16(q), aligned16(k), aligned16(v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry("offset", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), h, sq, skv,
        d, kv_group, int(q_offset), kv_len, int(window), float(scale),
        stream)
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
    _check_cuda("flash_attention_static", q, k, v, causal, window,
                branch="static")
    if q.dtype == torch.bfloat16:
        q, k, v = aligned16(q), aligned16(k), aligned16(v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry("static", q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), h, sq, skv,
        d, kv_group, kv_len, int(window), int(causal), float(scale), stream)
    check_launch("flash_attention_static", status)
    flash_attention_static.launches += 1
    return out


def flash_attention_2d_q(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, k_scale: torch.Tensor, v_scale: torch.Tensor,
                         q_offset: int, kv_len: Optional[int] = None,
                         causal: bool = True, window: int = 0,
                         scale: Optional[float] = None, kv_group: int = 1,
                         block_kv: int = 512) -> torch.Tensor:
    """The offset branch over quantized K/V (K9c): q [Hq_, Sq, D]; k/v
    [Hkv_, Skv, D] int8 or float8_e4m3fn codes; ``k_scale``/``v_scale``
    [Hkv_, Skv] float32 per-position scales (each position carries its
    page's scale) -> [Hq_, Sq, D] in q's dtype."""
    _check("flash_attention_2d_q", q, k, v, kv_group)
    h, sq, d = q.shape
    hk, skv, _ = k.shape
    if (tuple(k_scale.shape) != (hk, skv)
            or tuple(v_scale.shape) != (hk, skv)):
        raise ValueError(f"flash_attention_2d_q: scales "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)} "
                         f"for K/V {tuple(k.shape)}")
    kv_len = skv if kv_len is None else int(kv_len)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kernel_path(q) == "plain":
        return ref.flash_attention_offset(
            q, k, v, q_offset=int(q_offset), kv_len=kv_len,
            kv_group=kv_group, scale=scale, causal=causal, window=window,
            block_kv=block_kv, k_scale=k_scale, v_scale=v_scale)
    if k.dtype not in CODE_DTYPES:
        raise TypeError("flash_attention_2d_q: K/V must be int8 or "
                        f"float8_e4m3fn codes, got {k.dtype}")
    _check_cuda("flash_attention_2d_q", q, k, v, causal, window, k.dtype,
                (k_scale, v_scale), branch="offset_q")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("flash_attention_2d_q: scales must be float32")
    if q.dtype == torch.bfloat16:
        q, k, v = aligned16(q), aligned16(k), aligned16(v)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry("offset_q", q.dtype, CODE_DTYPES[k.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), out.data_ptr(), h, sq, skv, d, kv_group,
        int(q_offset), kv_len, int(window), float(scale), stream)
    check_launch("flash_attention_2d_q", status)
    flash_attention_2d_q.launches += 1
    return out


flash_attention_2d.launches = 0
flash_attention_static.launches = 0
flash_attention_2d_q.launches = 0
