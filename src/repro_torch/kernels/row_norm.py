"""Row-wise LayerNorm for the kernel plan of the LayerNorm configs (gpt2's
ln1, ln2 and final norm).

``layer_norm_rows`` launches ``csrc/row_norm.cu`` on a CUDA tensor and runs
``ref.layer_norm_rows`` on a CPU tensor; ``.launches`` counts kernel
launches.  Not the port of a TPU kernel (the reference leaves the norm to
XLA): one block per row reducing in a fixed order makes a row's bits
independent of how many rows share the call, which exact speculative
acceptance needs (PyTorch's own LayerNorm picks its reduction by shape).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("row_norm")
    sym = ("repro_layer_norm_rows_bf16" if dtype == torch.bfloat16
           else "repro_layer_norm_rows_f32")
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp] * 4 + [i, i, ctypes.c_float, vp])


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
    status = _entry(x.dtype)(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                             out.data_ptr(), t, d, float(eps), stream)
    check_launch("layer_norm_rows", status)
    layer_norm_rows.launches += 1
    return out


layer_norm_rows.launches = 0
