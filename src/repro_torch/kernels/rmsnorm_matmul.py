"""Fused RMSNorm -> matmul (the plan's ``qkv`` stage, and the final norm
and LM head of the RMSNorm configs on the kernel plan).

``rmsnorm_matmul`` launches ``csrc/rmsnorm_matmul.cu`` on a CUDA tensor and
runs ``ref.rmsnorm_matmul`` on a CPU tensor; ``rmsnorm_matmul_w8`` is its
weight-only int8 twin (``ref.rmsnorm_matmul_w8``).  ``.launches`` on each
counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path, split_plan


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, w8: bool):
    lib = _build.load("rmsnorm_matmul")
    sym = ("repro_rmsnorm_matmul_" + ("w8_" if w8 else "")
           + ("bf16" if dtype == torch.bfloat16 else "f32"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp] * (6 if w8 else 5)
                          + [i] * 6 + [ctypes.c_float, vp])


def _check(name: str, x, scale, w) -> None:
    if (x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]
            or tuple(scale.shape) != (x.shape[1],)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, w {tuple(w.shape)}")


def _launch(name, x, scale, w, w_scale, eps) -> torch.Tensor:
    t, d = x.shape
    n = w.shape[1]
    out = torch.empty((t, n), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    small, k_per_split, splits = split_plan(t, d, n, sms)
    part = (torch.empty((splits, t, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [x.data_ptr(), scale.data_ptr(), w.data_ptr()]
    if w_scale is not None:
        ptrs.append(w_scale.data_ptr())
    status = _entry(x.dtype, w_scale is not None)(
        *ptrs, out.data_ptr(), part.data_ptr() if part is not None else None,
        t, d, n, int(small), k_per_split, splits, float(eps), stream)
    check_launch(name, status)
    return out


def rmsnorm_matmul(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                   *, eps: float = 1e-6) -> torch.Tensor:
    """x [T, D]; scale [D]; w [D, N] -> rms_norm(x) @ w [T, N] (x dtype).
    The CUDA kernel picks its own tiles (``split_plan``)."""
    _check("rmsnorm_matmul", x, scale, w)
    if kernel_path(x) == "plain":
        return ref.rmsnorm_matmul(x, scale, w, eps)
    check_cuda_operands("rmsnorm_matmul", x.dtype, x, scale, w)
    if scale.dtype != x.dtype or w.dtype != x.dtype:
        raise TypeError("rmsnorm_matmul: x, scale and w must share a dtype")
    out = _launch("rmsnorm_matmul", x, scale, w, None, eps)
    rmsnorm_matmul.launches += 1
    return out


def rmsnorm_matmul_w8(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                      *, w_scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """The weight-only int8 twin (K10a): w [D, N] int8 codes, ``w_scale``
    [N] float32 per-output-channel scales -> [T, N] in x's dtype.  The
    normalised row stays float32; the scale applies after the sum."""
    _check("rmsnorm_matmul_w8", x, scale, w)
    if tuple(w_scale.shape) != (w.shape[1],):
        raise ValueError(f"rmsnorm_matmul_w8: w {tuple(w.shape)}, w_scale "
                         f"{tuple(w_scale.shape)}")
    if kernel_path(x) == "plain":
        return ref.rmsnorm_matmul_w8(x, scale, w, w_scale, eps)
    check_cuda_operands("rmsnorm_matmul_w8", x.dtype, x, scale, w, w_scale)
    if (scale.dtype != x.dtype or w.dtype != torch.int8
            or w_scale.dtype != torch.float32):
        raise TypeError("rmsnorm_matmul_w8: scale in x's dtype, int8 codes "
                        "and float32 column scales expected; got "
                        f"{scale.dtype}, {w.dtype}, {w_scale.dtype}")
    out = _launch("rmsnorm_matmul_w8", x, scale, w, w_scale, eps)
    rmsnorm_matmul_w8.launches += 1
    return out


rmsnorm_matmul.launches = 0
rmsnorm_matmul_w8.launches = 0
