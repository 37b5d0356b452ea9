"""Fused RMSNorm -> matmul (the plan's ``qkv`` stage).

``rmsnorm_matmul`` launches ``csrc/rmsnorm_matmul.cu`` on a CUDA tensor and
runs ``ref.rmsnorm_matmul`` on a CPU tensor.  ``rmsnorm_matmul.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path

# Mirrors the tile shapes in csrc/rmsnorm_matmul.cu.
_BK = 32
_SMALL_T = 16            # T <= this: 8 x 128 tiles, else 64 x 64
_TILES = {True: (8, 128), False: (64, 64)}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(t: int, d: int, n: int, sms: int):
    """(small, k_per_split, splits): split K across blocks until the grid
    holds about two blocks per SM, keeping >= 4 K tiles per split."""
    small = t <= _SMALL_T
    bt, bn = _TILES[small]
    tiles = _cdiv(n, bn) * _cdiv(t, bt)
    want = max(1, min(_cdiv(2 * sms, tiles), d // (4 * _BK)))
    k_per_split = _cdiv(_cdiv(d, want), _BK) * _BK
    return small, k_per_split, _cdiv(d, k_per_split)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("rmsnorm_matmul")
    sym = ("repro_rmsnorm_matmul_bf16" if dtype == torch.bfloat16
           else "repro_rmsnorm_matmul_f32")
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                     ctypes.c_float, vp])


def rmsnorm_matmul(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                   *, eps: float = 1e-6) -> torch.Tensor:
    """x [T, D]; scale [D]; w [D, N] -> rms_norm(x) @ w [T, N] (x dtype).
    The CUDA kernel picks its own tiles (``split_plan``)."""
    t, d = x.shape
    d2, n = w.shape
    if d != d2 or tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm_matmul: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, w {tuple(w.shape)}")
    if kernel_path(x) == "plain":
        return ref.rmsnorm_matmul(x, scale, w, eps)
    check_cuda_operands("rmsnorm_matmul", x.dtype, x, scale, w)
    if scale.dtype != x.dtype or w.dtype != x.dtype:
        raise TypeError("rmsnorm_matmul: x, scale and w must share a dtype")
    out = torch.empty((t, n), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    small, k_per_split, splits = split_plan(t, d, n, sms)
    part = (torch.empty((splits, t, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry(x.dtype)(
        x.data_ptr(), scale.data_ptr(), w.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, t, d, n, int(small),
        k_per_split, splits, float(eps), stream)
    check_launch("rmsnorm_matmul", status)
    rmsnorm_matmul.launches += 1
    return out


rmsnorm_matmul.launches = 0
