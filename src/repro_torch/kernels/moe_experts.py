"""Dense-gather MoE experts (the plan's ``ffn`` for the MoE family, K12).

``moe_experts`` launches ``csrc/moe_experts.cu`` on a CUDA tensor and runs
``ref.moe_experts`` on a CPU tensor; ``moe_experts.launches`` counts kernel
launches.  The CUDA kernel runs SiLU, the only activation of the ported
MoE configs; on the card other activations are refused until a config
needs them, while the plain version covers them all.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path

_ACTS = ("silu", "gelu")          # the plain version's
# csrc/moe_experts.cu's small tile class (8-row tiles) serves up to this
# many rows, the large class (64-row tiles) the rest.
_SMALL_T = 16


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("moe_experts")
    sym = ("repro_moe_experts_bf16" if dtype == torch.bfloat16
           else "repro_moe_experts_f32")
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp] * 8 + [i] * 5 + [vp])


def moe_experts(x: torch.Tensor, gates: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor, wd: torch.Tensor, *,
                activation: str = "silu") -> torch.Tensor:
    """x [T, D]; gates [T, E] (zero off the top-k); wg/wu [E, D, F]; wd
    [E, F, D] -> the gate-weighted sum of every expert's GLU FFN [T, D]
    (x dtype, float32 sums)."""
    t, d = x.shape
    e, d2, f = wg.shape
    if (d != d2 or tuple(gates.shape) != (t, e)
            or tuple(wu.shape) != (e, d, f) or tuple(wd.shape) != (e, f, d)):
        raise ValueError(f"moe_experts: x {tuple(x.shape)}, gates "
                         f"{tuple(gates.shape)}, wg {tuple(wg.shape)}, wu "
                         f"{tuple(wu.shape)}, wd {tuple(wd.shape)}")
    if activation not in _ACTS:
        raise ValueError(f"moe_experts: unknown activation {activation!r}")
    if kernel_path(x) == "plain":
        return ref.moe_experts(x, gates, wg, wu, wd, activation=activation)
    if activation != "silu":
        raise ValueError("moe_experts: the CUDA kernel runs SiLU; got "
                         f"activation {activation!r}")
    ops = [x, gates, wg, wu, wd]
    check_cuda_operands("moe_experts", x.dtype, *ops)
    if any(o.dtype != x.dtype for o in ops):
        raise TypeError("moe_experts: operands must share the x dtype")
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    h = torch.empty((e, t, f), dtype=x.dtype, device=x.device)
    part = torch.empty((e, t, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry(x.dtype)(
        x.data_ptr(), gates.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), h.data_ptr(), part.data_ptr(), out.data_ptr(), t, d,
        f, e, int(t <= _SMALL_T), stream)
    check_launch("moe_experts", status)
    moe_experts.launches += 1
    return out


moe_experts.launches = 0
