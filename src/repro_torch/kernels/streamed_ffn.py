"""Stream-fused GLU FFN with the RMSNorm folded in (the plan's ``ffn``).

``streamed_ffn`` launches ``csrc/streamed_ffn.cu`` on a CUDA tensor and runs
``ref.streamed_ffn`` on a CPU tensor.  ``streamed_ffn.launches`` counts
kernel launches.  Only the gated path is ported; the ungated
``streamed_mlp`` comes with the gpt2 slice.  The CUDA kernel covers what
the llama3 main path runs (SiLU, norm folded in); on the card other
activations and a missing ``norm_scale`` are refused until a slice whose
config needs them adds them.  The plain version covers them all.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path

_SMALL_T = 16                     # mirrors csrc/streamed_ffn.cu
_BF = {True: 64, False: 128}
_ACTS = ("silu", "gelu")          # the plain version's; the kernel: silu


def workspace_shape(t: int, d: int, f: int):
    """Float32 partials [F / BF, T, D] the kernel sums in a second pass."""
    bf = _BF[t <= _SMALL_T]
    return (-(-f // bf), t, d)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("streamed_ffn")
    sym = ("repro_streamed_ffn_bf16" if dtype == torch.bfloat16
           else "repro_streamed_ffn_f32")
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp, vp, vp, vp, vp, vp, vp, i, i, i, i,
                                     ctypes.c_float, vp])


def streamed_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor, *, activation: str = "silu",
                 norm_scale: Optional[torch.Tensor] = None,
                 norm_eps: float = 1e-6) -> torch.Tensor:
    """x [T, D]; wg/wu [D, F]; wd [F, D] -> [T, D] (x dtype).

    ``norm_scale`` [D] folds ``rms_norm(x, norm_scale)`` into the kernel."""
    t, d = x.shape
    d2, f = wg.shape
    if (d != d2 or tuple(wu.shape) != (d, f) or tuple(wd.shape) != (f, d)
            or (norm_scale is not None and tuple(norm_scale.shape) != (d,))):
        raise ValueError(f"streamed_ffn: x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)}")
    if activation not in _ACTS:
        raise ValueError(f"streamed_ffn: unknown activation {activation!r}")
    if kernel_path(x) == "plain":
        return ref.streamed_ffn(x, wg, wu, wd, activation=activation,
                                norm_scale=norm_scale, norm_eps=norm_eps)
    if activation != "silu" or norm_scale is None:
        raise ValueError("streamed_ffn: the CUDA kernel runs SiLU with the "
                         f"norm folded in; got activation {activation!r}"
                         + (", no norm_scale" if norm_scale is None else ""))
    ops = [x, wg, wu, wd, norm_scale]
    check_cuda_operands("streamed_ffn", x.dtype, *ops)
    if any(o.dtype != x.dtype for o in ops):
        raise TypeError("streamed_ffn: operands must share the x dtype")
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    part = torch.empty(workspace_shape(t, d, f), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry(x.dtype)(
        x.data_ptr(), norm_scale.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), out.data_ptr(), part.data_ptr(), t, d, f,
        int(t <= _SMALL_T), float(norm_eps), stream)
    check_launch("streamed_ffn", status)
    streamed_ffn.launches += 1
    return out


streamed_ffn.launches = 0
