"""Tiled matmul (the plan's ``qkv`` stage for the LayerNorm configs).

``block_matmul`` launches ``csrc/block_matmul.cu`` on a CUDA tensor and runs
``ref.block_matmul`` on a CPU tensor.  ``block_matmul.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path, split_plan


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("block_matmul")
    sym = ("repro_block_matmul_bf16" if dtype == torch.bfloat16
           else "repro_block_matmul_f32")
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp, vp, vp, vp, i, i, i, i, i, i, vp])


def block_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K]; w [K, N] -> x @ w [M, N] (x dtype, float32 sums).  The
    CUDA kernel picks its own tiles (``split_plan``)."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"block_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if kernel_path(x) == "plain":
        return ref.block_matmul(x, w)
    check_cuda_operands("block_matmul", x.dtype, x, w)
    if w.dtype != x.dtype:
        raise TypeError("block_matmul: x and w must share a dtype")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    small, k_per_split, splits = split_plan(m, k, n, sms)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry(x.dtype)(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, m, k, n, int(small),
        k_per_split, splits, stream)
    check_launch("block_matmul", status)
    block_matmul.launches += 1
    return out


block_matmul.launches = 0
