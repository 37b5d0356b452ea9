"""Stream-fused FFNs (the plan's ``ffn``): the GLU ``streamed_ffn`` with
the RMSNorm folded in, and the ungated ``streamed_mlp``.

Each launches its entry points in ``csrc/streamed_ffn.cu`` on a CUDA tensor
and runs its plain version (``ref.streamed_ffn`` / ``ref.streamed_mlp``)
on a CPU tensor; ``.launches`` on each counts its kernel launches.  The
CUDA kernel covers what the main paths run: SiLU with the norm folded in
for ``streamed_ffn`` (llama3), GELU without a folded norm for
``streamed_mlp`` (gpt2).  On the card the other cases are refused until a
slice whose config needs them adds them; the plain versions cover them
all.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref
from .common import (ROW_INVARIANT_T, check_cuda_operands, check_launch,
                     kernel_path)

# Tile classes of csrc/streamed_ffn.cu: (largest T, BF).  Up to
# ROW_INVARIANT_T rows every class has BF = 64, so each output row sums the
# same F partials in the same order at any T there.
_TILES = ((16, 64), (ROW_INVARIANT_T, 64), (None, 128))
_ACTS = ("silu", "gelu")          # the plain versions'


def tile_class(t: int) -> int:
    """Index into ``_TILES`` of the kernel's tile shape for T rows."""
    return next(i for i, (top, _) in enumerate(_TILES)
                if top is None or t <= top)


def workspace_shape(t: int, d: int, f: int):
    """Float32 partials [F / BF, T, D] the kernel sums in a second pass."""
    bf = _TILES[tile_class(t)][1]
    return (-(-f // bf), t, d)


@functools.lru_cache(maxsize=None)
def _entry(kind: str, dtype: torch.dtype):
    """``kind``: "ffn" (GLU, folded norm) or "mlp" (ungated, no norm)."""
    lib = _build.load("streamed_ffn")
    sym = (f"repro_streamed_{kind}_"
           + ("bf16" if dtype == torch.bfloat16 else "f32"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    if kind == "ffn":
        args = [vp] * 7 + [i, i, i, i, ctypes.c_float, vp]
    else:
        args = [vp] * 5 + [i, i, i, i, vp]
    return _build.declare(lib, sym, args)


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
    status = _entry("ffn", x.dtype)(
        x.data_ptr(), norm_scale.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), out.data_ptr(), part.data_ptr(), t, d, f,
        tile_class(t), float(norm_eps), stream)
    check_launch("streamed_ffn", status)
    streamed_ffn.launches += 1
    return out


streamed_ffn.launches = 0


def streamed_mlp(x: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
                 activation: str = "gelu",
                 norm_scale: Optional[torch.Tensor] = None,
                 norm_eps: float = 1e-6) -> torch.Tensor:
    """x [T, D]; wu [D, F]; wd [F, D] -> act(x @ wu).to(x dtype) @ wd [T, D].

    ``norm_scale`` [D] folds ``rms_norm(x, norm_scale)`` into the kernel."""
    t, d = x.shape
    d2, f = wu.shape
    if (d != d2 or tuple(wd.shape) != (f, d)
            or (norm_scale is not None and tuple(norm_scale.shape) != (d,))):
        raise ValueError(f"streamed_mlp: x {tuple(x.shape)}, wu "
                         f"{tuple(wu.shape)}, wd {tuple(wd.shape)}")
    if activation not in _ACTS:
        raise ValueError(f"streamed_mlp: unknown activation {activation!r}")
    if kernel_path(x) == "plain":
        return ref.streamed_mlp(x, wu, wd, activation=activation,
                                norm_scale=norm_scale, norm_eps=norm_eps)
    if activation != "gelu" or norm_scale is not None:
        raise ValueError("streamed_mlp: the CUDA kernel runs GELU without a "
                         f"folded norm; got activation {activation!r}"
                         + (", a norm_scale" if norm_scale is not None
                            else ""))
    check_cuda_operands("streamed_mlp", x.dtype, x, wu, wd)
    if wu.dtype != x.dtype or wd.dtype != x.dtype:
        raise TypeError("streamed_mlp: operands must share the x dtype")
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    part = torch.empty(workspace_shape(t, d, f), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry("mlp", x.dtype)(
        x.data_ptr(), wu.data_ptr(), wd.data_ptr(), out.data_ptr(),
        part.data_ptr(), t, d, f, tile_class(t), stream)
    check_launch("streamed_mlp", status)
    streamed_mlp.launches += 1
    return out


streamed_mlp.launches = 0
