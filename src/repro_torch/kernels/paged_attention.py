"""Paged attention: single-token decode (the plan's ``decode_attn``) and
the speculative verify window (``verify_attn``).

Both wrappers launch the one window kernel in ``csrc/paged_attention.cu``
on a CUDA tensor (decode is the window at W = 1) and run their plain
versions (``ref.paged_decode_attention`` / ``ref.paged_verify_attention``)
on a CPU tensor; ``.launches`` on each counts its own kernel launches.
The CUDA kernel covers what the main paths run (no sliding window, head
dim 64 for gpt2 or 128 for llama3, up to ``MAX_ROWS`` window rows per KV
head); on the card the rest is refused until a slice whose config needs
it adds it.  The plain versions cover it all.  The quantized twins come
with their slice.
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
MAX_ROWS = 64             # window rows x query heads per KV head it holds


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("paged_attention")
    sym = ("repro_paged_window_bf16" if dtype == torch.bfloat16
           else "repro_paged_window_f32")
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                                     i, i, i, ctypes.c_float, vp])


def _check_shapes(name, q, k_pool, v_pool, page_table, base) -> None:
    b, _, hq, d = q.shape
    _, _, hkv, d2 = k_pool.shape
    if (d != d2 or tuple(v_pool.shape) != tuple(k_pool.shape) or hq % hkv
            or page_table.dim() != 2 or page_table.shape[0] != b
            or tuple(base.shape) != (b,)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(page_table.shape)}, per-slot operand "
                         f"{tuple(base.shape)}")


def _launch(name, q, k_pool, v_pool, page_table, base, *, extra: int,
            window: int, scale: float) -> torch.Tensor:
    """Launch the window kernel: row w of slot b sees ``base[b] + w +
    extra`` positions."""
    check_cuda_operands(name, q.dtype, q, k_pool, v_pool, page_table, base)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{name}: q and pools must share a dtype")
    if page_table.dtype != torch.int32 or base.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and the per-slot operand must "
                        "be int32")
    b, w, hq, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    g = hq // hkv
    if d not in HEAD_DIMS or w * g > MAX_ROWS or window:
        raise ValueError(f"{name}: the CUDA kernel runs head dims "
                         f"{HEAD_DIMS}, up to {MAX_ROWS} window rows x query "
                         f"heads per KV head, no window; got head dim {d}, "
                         f"{w} x {g} rows, window {window}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = _entry(q.dtype)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), base.data_ptr(), out.data_ptr(), b, hkv, g,
        w, extra, d, ps, page_table.shape[1], float(scale), stream)
    check_launch(name, status)
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q [B, 1, Hq, D]; pools [P, ps, Hkv, D]; page_table [B, maxp] int32
    (valid page ids, NULL page 0 where unallocated); lengths [B] int32
    valid entries per slot -> [B, 1, Hq, D].  Length 0 gives zeros."""
    _check_shapes("paged_decode_attention", q, k_pool, v_pool, page_table,
                  lengths)
    if q.shape[1] != 1:
        raise ValueError("paged_decode_attention: q must hold one token per "
                         f"slot, got {tuple(q.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kernel_path(q) == "plain":
        return ref.paged_decode_attention(q, k_pool, v_pool, page_table,
                                          lengths, window=window,
                                          scale=scale)
    out = _launch("paged_decode_attention", q, k_pool, v_pool, page_table,
                  lengths, extra=0, window=window, scale=scale)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           q_off: torch.Tensor, *, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """W-token speculative-verify attention against paged K/V pools.

    q [B, W, Hq, D], the pending token and W - 1 drafts per slot; pools
    [P, ps, Hkv, D]; page_table [B, maxp] int32; q_off [B] int32 the
    absolute position of window row 0, so row i attends to the first
    ``q_off + i + 1`` positions -> [B, W, Hq, D].  Row i equals
    ``paged_decode_attention`` at length ``q_off + i + 1``: bit for bit on
    the card, where both run one device function."""
    _check_shapes("paged_verify_attention", q, k_pool, v_pool, page_table,
                  q_off)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kernel_path(q) == "plain":
        return ref.paged_verify_attention(q, k_pool, v_pool, page_table,
                                          q_off, window=window, scale=scale)
    out = _launch("paged_verify_attention", q, k_pool, v_pool, page_table,
                  q_off, extra=1, window=window, scale=scale)
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0
