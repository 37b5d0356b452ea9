"""Stream-fused FFNs (the plan's ``ffn``): the GLU ``streamed_ffn`` with
the RMSNorm folded in, and the ungated ``streamed_mlp``.

Each launches its entry points in ``csrc/streamed_ffn.cu`` on a CUDA tensor
and runs its plain version (``ref.streamed_ffn`` / ``ref.streamed_mlp``)
on a CPU tensor; ``.launches`` on each counts its kernel launches.
``streamed_ffn_w8`` / ``streamed_mlp_w8`` are their weight-only int8
twins (int8 codes with float32 per-output-channel scales; plain versions
``ref.streamed_ffn_w8`` / ``ref.streamed_mlp_w8``), with their own
counts.  The
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
    """``kind``: "ffn" (GLU, folded norm) or "mlp" (ungated, no norm), with
    "_w8" for the int8 twin."""
    lib = _build.load("streamed_ffn")
    sym = (f"repro_streamed_{kind}_"
           + ("bf16" if dtype == torch.bfloat16 else "f32"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    ptrs = {"ffn": 7, "mlp": 5, "ffn_w8": 10, "mlp_w8": 7}[kind]
    tail = [ctypes.c_float, vp] if kind.startswith("ffn") else [vp]
    return _build.declare(lib, sym, [vp] * ptrs + [i] * 4 + tail)


def _check_w8(name: str, x, codes, scales) -> None:
    """Launch preconditions of an int8 twin: int8 codes, float32 scales."""
    check_cuda_operands(name, x.dtype, x, *codes, *scales)
    if (any(c.dtype != torch.int8 for c in codes)
            or any(s.dtype != torch.float32 for s in scales)):
        raise TypeError(f"{name}: int8 codes and float32 scales expected")


def _run(kind: str, name: str, x, ptrs, d: int, f: int, eps=None):
    """Allocate the output and the F-partials workspace and launch."""
    t = x.shape[0]
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    part = torch.empty(workspace_shape(t, d, f), dtype=torch.float32,
                       device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tail = [] if eps is None else [float(eps)]
    status = _entry(kind, x.dtype)(
        x.data_ptr(), *(p.data_ptr() for p in ptrs), out.data_ptr(),
        part.data_ptr(), t, d, f, tile_class(t), *tail, stream)
    check_launch(name, status)
    return out


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
    out = _run("ffn", "streamed_ffn", x, (norm_scale, wg, wu, wd), d, f,
               norm_eps)
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
    out = _run("mlp", "streamed_mlp", x, (wu, wd), d, f)
    streamed_mlp.launches += 1
    return out


streamed_mlp.launches = 0


def streamed_ffn_w8(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor, *, wg_scale: torch.Tensor,
                    wu_scale: torch.Tensor, wd_scale: torch.Tensor,
                    activation: str = "silu",
                    norm_scale: Optional[torch.Tensor] = None,
                    norm_eps: float = 1e-6) -> torch.Tensor:
    """The weight-only int8 twin of ``streamed_ffn`` (K10b): wg/wu [D, F]
    and wd [F, D] int8 codes; ``wg_scale``/``wu_scale`` [F] and
    ``wd_scale`` [D] float32 -> [T, D] in x's dtype."""
    t, d = x.shape
    f = wg.shape[1]
    if (tuple(wg.shape) != (d, f) or tuple(wu.shape) != (d, f)
            or tuple(wd.shape) != (f, d) or tuple(wg_scale.shape) != (f,)
            or tuple(wu_scale.shape) != (f,)
            or tuple(wd_scale.shape) != (d,)
            or (norm_scale is not None and tuple(norm_scale.shape) != (d,))):
        raise ValueError(f"streamed_ffn_w8: x {tuple(x.shape)}, wg "
                         f"{tuple(wg.shape)}, wu {tuple(wu.shape)}, wd "
                         f"{tuple(wd.shape)}")
    if activation not in _ACTS:
        raise ValueError(f"streamed_ffn_w8: unknown activation "
                         f"{activation!r}")
    if kernel_path(x) == "plain":
        return ref.streamed_ffn_w8(x, wg, wu, wd, wg_scale=wg_scale,
                                   wu_scale=wu_scale, wd_scale=wd_scale,
                                   activation=activation,
                                   norm_scale=norm_scale, norm_eps=norm_eps)
    if activation != "silu" or norm_scale is None:
        raise ValueError("streamed_ffn_w8: the CUDA kernel runs SiLU with "
                         f"the norm folded in; got activation {activation!r}"
                         + (", no norm_scale" if norm_scale is None else ""))
    _check_w8("streamed_ffn_w8", x, (wg, wu, wd),
              (wg_scale, wu_scale, wd_scale))
    if norm_scale.dtype != x.dtype or not norm_scale.is_contiguous():
        raise TypeError("streamed_ffn_w8: norm_scale must be a contiguous "
                        "tensor of x's dtype")
    out = _run("ffn_w8", "streamed_ffn_w8", x,
               (norm_scale, wg, wg_scale, wu, wu_scale, wd, wd_scale), d, f,
               norm_eps)
    streamed_ffn_w8.launches += 1
    return out


streamed_ffn_w8.launches = 0


def streamed_mlp_w8(x: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
                    wu_scale: torch.Tensor, wd_scale: torch.Tensor,
                    activation: str = "gelu",
                    norm_scale: Optional[torch.Tensor] = None,
                    norm_eps: float = 1e-6) -> torch.Tensor:
    """The weight-only int8 twin of ``streamed_mlp`` (K10c): wu [D, F] and
    wd [F, D] int8 codes; ``wu_scale`` [F] and ``wd_scale`` [D] float32
    -> [T, D] in x's dtype."""
    t, d = x.shape
    f = wu.shape[1]
    if (tuple(wu.shape) != (d, f) or tuple(wd.shape) != (f, d)
            or tuple(wu_scale.shape) != (f,)
            or tuple(wd_scale.shape) != (d,)
            or (norm_scale is not None and tuple(norm_scale.shape) != (d,))):
        raise ValueError(f"streamed_mlp_w8: x {tuple(x.shape)}, wu "
                         f"{tuple(wu.shape)}, wd {tuple(wd.shape)}")
    if activation not in _ACTS:
        raise ValueError(f"streamed_mlp_w8: unknown activation "
                         f"{activation!r}")
    if kernel_path(x) == "plain":
        return ref.streamed_mlp_w8(x, wu, wd, wu_scale=wu_scale,
                                   wd_scale=wd_scale, activation=activation,
                                   norm_scale=norm_scale, norm_eps=norm_eps)
    if activation != "gelu" or norm_scale is not None:
        raise ValueError("streamed_mlp_w8: the CUDA kernel runs GELU without "
                         f"a folded norm; got activation {activation!r}"
                         + (", a norm_scale" if norm_scale is not None
                            else ""))
    _check_w8("streamed_mlp_w8", x, (wu, wd), (wu_scale, wd_scale))
    out = _run("mlp_w8", "streamed_mlp_w8", x, (wu, wu_scale, wd, wd_scale),
               d, f)
    streamed_mlp_w8.launches += 1
    return out


streamed_mlp_w8.launches = 0
