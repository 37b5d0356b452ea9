"""Row-wise norms for the kernel plan's serving path: LayerNorm for the
LayerNorm configs (gpt2's ln1, ln2 and final norm), RMSNorm where the plan
folds it into no kernel (the MoE family's ln2).

``layer_norm_rows`` and ``rms_norm_rows`` launch ``csrc/row_norm.cu`` on a
CUDA tensor and run ``ref.layer_norm_rows`` / ``ref.rms_rows`` on a CPU
tensor; ``.launches`` on each counts its kernel launches.  Not the port of
a TPU kernel (the reference leaves the norms to XLA): one block per row
reducing in a fixed order makes a row's bits independent of how many rows
share the call, which exact speculative acceptance needs (PyTorch's own
norms pick their reductions by shape).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path


@functools.lru_cache(maxsize=None)
def _entry(kind: str, dtype: torch.dtype):
    """``kind``: "layer" or "rms"."""
    lib = _build.load("row_norm")
    sym = (f"repro_{kind}_norm_rows_"
           + ("bf16" if dtype == torch.bfloat16 else "f32"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    ptrs = 4 if kind == "layer" else 3
    return _build.declare(lib, sym, [vp] * ptrs + [i, i, ctypes.c_float, vp])


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    *, eps: float = 1e-5) -> torch.Tensor:
    """x [T, D]; scale, bias [D] -> LayerNorm of each row [T, D] (x dtype):
    ``(x - mean) * rsqrt(var + eps) * scale + bias`` with the raw scale and
    the population variance, statistics in float32."""
    if (x.dim() != 2 or tuple(scale.shape) != (x.shape[1],)
            or tuple(bias.shape) != (x.shape[1],)):
        raise ValueError(f"layer_norm_rows: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)}")
    if kernel_path(x) == "plain":
        return ref.layer_norm_rows(x, scale, bias, eps)
    check_cuda_operands("layer_norm_rows", x.dtype, x, scale, bias)
    if scale.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError("layer_norm_rows: x, scale and bias must share a "
                        "dtype")
    t, d = x.shape
    out = torch.empty_like(x)
    if t == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry("layer", x.dtype)(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), t, d,
        float(eps), stream)
    check_launch("layer_norm_rows", status)
    layer_norm_rows.launches += 1
    return out


layer_norm_rows.launches = 0


def rms_norm_rows(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """x [T, D]; scale [D] -> RMSNorm of each row [T, D] (x dtype):
    ``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in float32."""
    if x.dim() != 2 or tuple(scale.shape) != (x.shape[1],):
        raise ValueError(f"rms_norm_rows: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}")
    if kernel_path(x) == "plain":
        return ref.rms_rows(x, scale, eps)
    check_cuda_operands("rms_norm_rows", x.dtype, x, scale)
    if scale.dtype != x.dtype:
        raise TypeError("rms_norm_rows: x and scale must share a dtype")
    t, d = x.shape
    out = torch.empty_like(x)
    if t == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry("rms", x.dtype)(x.data_ptr(), scale.data_ptr(),
                                    out.data_ptr(), t, d, float(eps), stream)
    check_launch("rms_norm_rows", status)
    rms_norm_rows.launches += 1
    return out


rms_norm_rows.launches = 0
