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
from .common import check_cuda_operands, check_launch, kernel_path, split_plan


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
