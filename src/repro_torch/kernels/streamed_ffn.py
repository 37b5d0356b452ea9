"""Stream-fused FFNs (the plan's ``ffn``): the GLU ``streamed_ffn`` with
the RMSNorm folded in, and the ungated ``streamed_mlp``.

Each launches its entry points in ``csrc/streamed_ffn.cu`` (the int8
twins': ``csrc/streamed_ffn_w8.cu``) on a CUDA tensor and runs its plain
version (``ref.streamed_ffn`` / ``ref.streamed_mlp``) on a CPU tensor;
``.launches`` on each counts its calls that launch.  ``streamed_ffn_w8``
/ ``streamed_mlp_w8`` are their weight-only int8 twins (int8 codes with
float32 per-output-channel scales; plain versions ``ref.streamed_ffn_w8``
/ ``ref.streamed_mlp_w8``), with their own counts.  bfloat16 runs the
tensor-core kernel (``ffn_mma_kernel``, planned by ``common.ffn_plan``:
one fused launch up to 64 rows, two passes through h above), float32
the CUDA-core kernel (its F partials summed by a second launch), which
keeps float32 products exact.  The CUDA kernels cover what the main paths
run: for ``streamed_ffn`` SiLU with the norm folded in
(llama3), GELU with the norm folded in (gemma3) and GELU without a folded
norm (zamba2's shared block), GELU without a folded norm for
``streamed_mlp`` (gpt2); the int8 twins the same four.
On the card the other cases are refused until a slice whose config needs
them adds them; the plain versions cover them all.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build, ref
from .common import (FFN_BF, FFN_BN, FFN_BT, FFN_DOWN, FFN_FUSED, FFN_TILES,
                     FFN_UP, HOPPER_SMS, ROW_INVARIANT_T, cdiv,
                     check_cuda_operands, check_launch, ffn_mma_smem,
                     ffn_plan, ffn_tile_name, kernel_path, round_up,
                     sm_count)

# Tile classes of the float32 kernel in csrc/streamed_ffn.cu: (largest T,
# BF).  Up to ROW_INVARIANT_T rows every class has BF = 64, so each output
# row sums the same F partials in the same order at any T there.
_TILES = ((16, 64), (ROW_INVARIANT_T, 64), (None, 128))
_ACTS = ("silu", "gelu")          # the plain versions'
# Per device, the bf16 kernel's split workspace: float32 partials [splits,
# T, D] and one int32 arrival counter per output tile, all 0 between
# launches (the last block on a tile resets its own).  Calls on one stream
# run one after another, so one workspace serves them; it grows to the
# largest split seen (234 MB at llama3's 64 rows, 21 MB at its 128-row
# chunk).
_WORKSPACE: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
# The C signature's pointer operands, in order (null where unused).
_OPERANDS = ("nscale", "wg", "gs", "wu", "us", "wd", "ds")
# The float32 entry points' pointer operands, per kind.
_F32_OPERANDS = {
    "ffn": ("nscale", "wg", "wu", "wd"),
    "ffn_gelu": ("wg", "wu", "wd"),
    "ffn_gelu_norm": ("nscale", "wg", "wu", "wd"),
    "mlp": ("wu", "wd"),
    "ffn_w8": ("nscale", "wg", "gs", "wu", "us", "wd", "ds"),
    "ffn_gelu_w8": ("wg", "gs", "wu", "us", "wd", "ds"),
    "ffn_gelu_norm_w8": ("nscale", "wg", "gs", "wu", "us", "wd", "ds"),
    "mlp_w8": ("wu", "us", "wd", "ds"),
}
# The kinds with the norm folded in (their float32 entry points take eps).
_NORM_KINDS = ("ffn", "ffn_gelu_norm", "ffn_w8", "ffn_gelu_norm_w8")


# The float32 kernel's instances per tile class: (BT, BF, TM1, TN1, BN2,
# TM2, TN2) of csrc/streamed_ffn.cuh.
_F32_INSTANCES = ((8, 64, 1, 2, 128, 1, 4), (32, 64, 2, 4, 128, 2, 8),
                  (64, 128, 4, 8, 128, 4, 8))


def cuda_refusal(gated: bool, activation: str, norm: bool) -> Optional[str]:
    """Why the CUDA build refuses an FFN, or None when it runs it: the GLU
    with SiLU and the norm folded in or with GELU, the ungated MLP with
    GELU and no norm.  The wrappers raise with it; the static checks
    report it (``analysis/kernel_lint.py``)."""
    if gated:
        if (activation, norm) in (("silu", True), ("gelu", False),
                                  ("gelu", True)):
            return None
        return ("the CUDA kernel runs SiLU with the norm folded in or "
                f"GELU; got activation {activation!r}"
                + (", a norm_scale" if norm else ", no norm_scale"))
    if activation == "gelu" and not norm:
        return None
    return ("the CUDA kernel runs the ungated MLP with GELU and no folded "
            f"norm; got activation {activation!r}, norm {norm}")


def smem_bytes(t: int, d: int, f: int, dtype: torch.dtype, *,
               gated: bool, norm: bool, silu: bool, w8: bool = False,
               sms: int = HOPPER_SMS) -> dict:
    """{kernel: static + dynamic shared memory per block} of a call at
    ``t`` rows (``ffn_plan`` on ``sms`` SMs picks the mode and, fused, the
    h slice's width).  bf16: ``ffn_mma_kernel`` (``ffn_mma_smem``), beside
    its static arrays, the rstd rows of a folded norm and the arrival flag
    (rounded to 128 bytes, the ring's alignment): one fused launch up to
    64 rows, else the norm's row pass, UP and DOWN.  float32: the
    CUDA-core kernel's static tiles (the staging buffer, the rstd rows, the
    h tile), then the split sum."""
    def b(flag) -> str:                 # a template's bool argument
        return str(bool(flag)).lower()
    if dtype != torch.bfloat16:
        bt, bf, *rest = _F32_INSTANCES[tile_class(t)]
        stage = max(8 * (bt + 1) + 2 * 8 * bf, 8 * rest[2])
        static = 4 * (stage + (bt if norm else 0) + bf * bt)
        w = "signed char" if w8 else "float"
        inst = ", ".join(str(v) for v in (bt, bf, *rest))
        return {f"streamed_ffn_kernel<float, {w}, {b(gated)}, {b(norm)}, "
                f"{b(silu)}, {inst}>": round_up(static, 128),
                "split_reduce_kernel<float>": 0}
    mode, f_per_split, _ = ffn_plan(t, d, f, sms)

    def entry(tile, kmode, glu, knorm, ksilu, fps=0):
        bt = FFN_TILES[tile][0]
        static = (4 * bt if knorm else 0) + (4 if kmode != FFN_UP else 0)
        name = (f"ffn_mma_kernel<{ffn_tile_name(tile)}, {b(w8)}, {kmode}, "
                f"{b(glu)}, {b(knorm)}, {b(ksilu)}>")
        return name, (round_up(static, 128)
                      + ffn_mma_smem(tile, w8, kmode, glu, fps))

    if mode == 0:
        tile = "decode" if t <= FFN_TILES["decode"][0] else "verify"
        return dict([entry(tile, FFN_FUSED, gated, norm, silu,
                           f_per_split)])
    out = dict([entry("pass", FFN_UP, gated, False, silu),
                entry("pass", FFN_DOWN, False, False, False)])
    if norm:
        out["rms_rows_kernel"] = 0
    return out


def tile_class(t: int) -> int:
    """Index into ``_TILES`` of the float32 kernel's tile shape for T
    rows."""
    return next(i for i, (top, _) in enumerate(_TILES)
                if top is None or t <= top)


def workspace_shape(t: int, d: int, f: int):
    """Float32 partials [F / BF, T, D] the float32 kernel sums in a second
    pass."""
    bf = _TILES[tile_class(t)][1]
    return (-(-f // bf), t, d)


@functools.lru_cache(maxsize=None)
def _entry(kind: str, dtype: torch.dtype):
    """``kind``: "ffn" (GLU, SiLU, folded norm), "ffn_gelu_norm" (GLU,
    GELU, folded norm), "ffn_gelu" (GLU, GELU, no norm) or "mlp" (ungated,
    no norm), with "_w8" for the int8 twin (``streamed_ffn_w8``'s library).
    The bf16 entry points (the tensor-core kernel) share one signature."""
    lib = _build.load("streamed_ffn_w8" if kind.endswith("_w8")
                      else "streamed_ffn")
    vp, i = ctypes.c_void_p, ctypes.c_int
    if dtype == torch.bfloat16:
        return _build.declare(lib, f"repro_streamed_{kind}_mma_bf16",
                              [vp] * 13 + [i] * 7 + [ctypes.c_float, vp])
    tail = [ctypes.c_float, vp] if kind in _NORM_KINDS else [vp]
    return _build.declare(lib, f"repro_streamed_{kind}_f32",
                          [vp] * (len(_F32_OPERANDS[kind]) + 3) + [i] * 4
                          + tail)


def _workspace(device: torch.device, floats: int, tiles: int):
    """(partials, counters) with room for ``floats`` and ``tiles``."""
    part, ctr = _WORKSPACE.get(device, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1 << 20), dtype=torch.float32,
                           device=device)
    if ctr is None or ctr.numel() < tiles:
        ctr = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
    _WORKSPACE[device] = part, ctr
    return part, ctr


def _check_w8(name: str, x, codes, scales) -> None:
    """Launch preconditions of an int8 twin: int8 codes, float32 scales."""
    check_cuda_operands(name, x.dtype, x, *codes, *scales)
    if (any(c.dtype != torch.int8 for c in codes)
            or any(s.dtype != torch.float32 for s in scales)):
        raise TypeError(f"{name}: int8 codes and float32 scales expected")


def _glu_kind(name: str, activation: str, norm_scale,
              w8: bool = False) -> str:
    """The GLU entry point for an activation and norm setting: SiLU with
    the norm folded in, GELU with or without it; the card refuses the
    rest."""
    why = cuda_refusal(True, activation, norm_scale is not None)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    kind = {("silu", True): "ffn", ("gelu", False): "ffn_gelu",
            ("gelu", True): "ffn_gelu_norm"}[
                (activation, norm_scale is not None)]
    return kind + "_w8" if w8 else kind


def _run(kind: str, name: str, x, d: int, f: int, eps: float = 0.0,
         **ops):
    """Allocate the output and the workspace and launch; ``ops`` holds the
    named operands of ``_OPERANDS`` the kind takes."""
    t = x.shape[0]
    dev = x.device
    out = torch.empty((t, d), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if x.dtype != torch.bfloat16:
        part = torch.empty(workspace_shape(t, d, f), dtype=torch.float32,
                           device=dev)
        tail = [float(eps)] if kind in _NORM_KINDS else []
        status = _entry(kind, x.dtype)(
            x.data_ptr(), *(ops[k].data_ptr() for k in _F32_OPERANDS[kind]),
            out.data_ptr(), part.data_ptr(), t, d, f, tile_class(t), *tail,
            stream)
        check_launch(name, status)
        return out
    mode, f_per_split, splits = ffn_plan(t, d, f, sm_count(dev))
    part = ctr = h = xn = None
    if splits > 1:
        part, ctr = _workspace(dev, splits * t * d,
                               cdiv(d, FFN_BN) * cdiv(t, FFN_BT))
    if mode == 1:
        planes = 2 if kind.endswith("_w8") else 1
        h = torch.empty((planes, t, round_up(f, FFN_BF)),
                        dtype=torch.bfloat16, device=dev)
        if "nscale" in ops:
            xn = torch.empty((t, d), dtype=x.dtype, device=dev)
    tensors = [x] + [ops[k] for k in ("wg", "wu", "wd") if k in ops]
    aligned = (d % 16 == 0 and f % 16 == 0
               and all(o.data_ptr() % 16 == 0 for o in tensors))
    ptr = (lambda o: o.data_ptr() if o is not None else None)
    status = _entry(kind, x.dtype)(
        x.data_ptr(), *(ptr(ops.get(k)) for k in _OPERANDS), out.data_ptr(),
        ptr(part), ptr(ctr), ptr(h), ptr(xn), t, d, f, mode, f_per_split,
        splits, int(aligned), float(eps), stream)
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
    kind = _glu_kind("streamed_ffn", activation, norm_scale)
    norm = {"nscale": norm_scale} if kind in _NORM_KINDS else {}
    ops = [x, wg, wu, wd, *norm.values()]
    check_cuda_operands("streamed_ffn", x.dtype, *ops)
    if any(o.dtype != x.dtype for o in ops):
        raise TypeError("streamed_ffn: operands must share the x dtype")
    out = _run(kind, "streamed_ffn", x, d, f, norm_eps, wg=wg, wu=wu, wd=wd,
               **norm)
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
    why = cuda_refusal(False, activation, norm_scale is not None)
    if why is not None:
        raise ValueError(f"streamed_mlp: {why}")
    check_cuda_operands("streamed_mlp", x.dtype, x, wu, wd)
    if wu.dtype != x.dtype or wd.dtype != x.dtype:
        raise TypeError("streamed_mlp: operands must share the x dtype")
    out = _run("mlp", "streamed_mlp", x, d, f, wu=wu, wd=wd)
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
    kind = _glu_kind("streamed_ffn_w8", activation, norm_scale, w8=True)
    _check_w8("streamed_ffn_w8", x, (wg, wu, wd),
              (wg_scale, wu_scale, wd_scale))
    norm = {}
    if kind in _NORM_KINDS:
        if norm_scale.dtype != x.dtype or not norm_scale.is_contiguous():
            raise TypeError("streamed_ffn_w8: norm_scale must be a "
                            "contiguous tensor of x's dtype")
        norm = {"nscale": norm_scale}
    out = _run(kind, "streamed_ffn_w8", x, d, f, norm_eps, wg=wg,
               gs=wg_scale, wu=wu, us=wu_scale, wd=wd, ds=wd_scale, **norm)
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
    why = cuda_refusal(False, activation, norm_scale is not None)
    if why is not None:
        raise ValueError(f"streamed_mlp_w8: {why}")
    _check_w8("streamed_mlp_w8", x, (wu, wd), (wu_scale, wd_scale))
    out = _run("mlp_w8", "streamed_mlp_w8", x, d, f, wu=wu, us=wu_scale,
               wd=wd, ds=wd_scale)
    streamed_mlp_w8.launches += 1
    return out


streamed_mlp_w8.launches = 0
