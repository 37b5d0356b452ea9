"""MoE experts (the plan's ``ffn`` for the MoE family, K12).

``moe_experts`` launches ``csrc/moe_experts.cu`` on a CUDA tensor and runs
``ref.moe_experts`` on a CPU tensor; ``moe_experts.launches`` counts its
calls that launch.  On the card only the (token, expert) pairs the gates
keep are computed: a route pass on the device lists each expert's kept
tokens, the products run over those rows alone, and a combine sums each
token's kept experts in expert order, which gives the reference's float32
sum (a dropped pair adds ``y * 0 = +-0``; see the kernel's header for the
two cases where it does not).  Nothing is read back to the host: the
grids are sized from T and E.  bfloat16 runs the tensor-core body of the
streamed FFN (planned by ``common.moe_plan``: up to 64 rows one fused
launch whose blocks list their expert's tokens, two passes through h
above), float32 the CUDA-core kernels, which keep float32 products
exact.  The CUDA kernels run SiLU, the only
activation of the ported MoE configs; on the card other activations are
refused until a config needs them, while the plain version covers them
all.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref
from .common import (FFN_BF, FFN_DOWN, FFN_FUSED, FFN_UP, MOE_BF,
                     check_cuda_operands, check_launch, ffn_mma_smem,
                     ffn_tile_name, kernel_path, moe_plan, round_up)

_ACTS = ("silu", "gelu")          # the plain version's
_CUDA_ACTS = ("silu",)            # the CUDA kernels'
# The autotuner's candidate lattice, the reference's
# (``repro/kernels/moe_experts.py:26``).  ``CARD_BLOCKS``: the names that
# change what the card runs, per compute dtype.  None: the wrapper takes no
# block (``models/layers.py`` drops ``block_t``), ``moe_plan`` decides.
TUNE_SPACE = {"block_t": (128, 256, 512)}
CARD_BLOCKS = {"bfloat16": (), "float32": ()}


def cuda_refusal(activation: str) -> Optional[str]:
    """Why the CUDA build refuses the experts' activation, or None."""
    if activation in _CUDA_ACTS:
        return None
    return f"the CUDA kernel runs SiLU; got activation {activation!r}"


def smem_bytes(t: int, d: int, f: int, dtype: torch.dtype) -> dict:
    """{kernel: static + dynamic shared memory per block} of a call at
    ``t`` rows (``moe_plan``), static arrays rounded to 128 bytes (the
    source's ring alignment).  bf16: the route (above 64 rows), the
    tensor-core body (``ffn_mma_smem``; static: the tile's token rows,
    the fused mode's two kept-token counts and arrival flag), the combine
    (each token's kept experts and gates).  float32: the route, the
    CUDA-core phase-1 and phase-2 tiles, the combine."""
    t8, t16 = t <= 8, t <= 16
    bf16 = dtype == torch.bfloat16
    tname = "__nv_bfloat16" if bf16 else "float"
    vec = 4 if d % 4 == 0 else 1
    out = {f"moe_combine_kernel<{tname}, {vec}>":
           round_up(4 * 256 + 4 * 256 + 4, 128)}
    if bf16 and moe_plan(t, f)[0] == 0:
        tile = "decode" if t8 else "moe16"
        out[f"moe_mma_kernel<{ffn_tile_name(tile)}, {FFN_FUSED}>"] = (
            round_up(4 * 16 + 8 + 4, 128)
            + ffn_mma_smem(tile, False, FFN_FUSED, True, MOE_BF))
        return out
    out[f"moe_route_kernel<{tname}>"] = round_up(4 * 8, 128)
    if bf16:
        for mode in (FFN_UP, FFN_DOWN):
            out[f"moe_mma_kernel<{ffn_tile_name('pass')}, {mode}>"] = (
                round_up(4 * 64, 128)
                + ffn_mma_smem("pass", False, mode, True, 0))
        return out
    bk = 16
    (bt, bf, tm, tn), (bt2, bn, tm2, tn2) = (
        ((8, 128, 1, 4), (8, 64, 1, 2)) if t16
        else ((64, 64, 4, 4), (64, 64, 4, 4)))
    out[f"moe_h_kernel<{bt}, {bf}, {tm}, {tn}>"] = round_up(
        4 * (bk * (bt + 1) + 2 * bk * bf + bt), 128)
    out[f"moe_out_kernel<{bt2}, {bn}, {tm2}, {tn2}>"] = round_up(
        4 * (bk * (bt2 + 1) + bk * bn + bt2), 128)
    return out
_ALIGN = 256                      # bytes between the workspace's parts
def workspace_layout(t: int, d: int, f: int, e: int, dtype: torch.dtype,
                     mode: int, splits: int):
    """(bytes, {part: (byte offset, shape, dtype)}) of the one workspace a
    call allocates (none of it needs zeroing): the route's idx [E, T] and
    counts [E] (int32), h and the float32 partials the combine sums.  bf16
    mode 0 (the fused launch lists each expert's tokens itself): partials
    [splits, E, T, D] alone; mode 1: h [E, T, F rounded up to 64] bf16 and
    partials [1, E, T, D]; float32: h [E, T, F] and partials [E, T, D]."""
    parts = []
    if dtype != torch.bfloat16 or mode == 1:
        parts += [("idx", (e, t), torch.int32), ("counts", (e,), torch.int32)]
    if dtype != torch.bfloat16:
        parts += [("h", (e, t, f), dtype), ("part", (e, t, d), torch.float32)]
    else:
        if mode == 1:
            parts.append(("h", (e, t, round_up(f, FFN_BF)), dtype))
        parts.append(("part", (splits, e, t, d), torch.float32))
    layout, off = {}, 0
    for name, shape, dt in parts:
        layout[name] = (off, shape, dt)
        n = dt.itemsize
        for s in shape:
            n *= s
        off = round_up(off + n, _ALIGN)
    return off, layout


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("moe_experts")
    vp, i = ctypes.c_void_p, ctypes.c_int
    if dtype == torch.bfloat16:
        return _build.declare(lib, "repro_moe_experts_bf16",
                              [vp] * 10 + [i] * 8 + [vp])
    return _build.declare(lib, "repro_moe_experts_f32",
                          [vp] * 10 + [i] * 4 + [vp])


def moe_experts(x: torch.Tensor, gates: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor, wd: torch.Tensor, *,
                activation: str = "silu") -> torch.Tensor:
    """x [T, D]; gates [T, E] (zero where the router drops an expert);
    wg/wu [E, D, F]; wd [E, F, D] -> the gate-weighted sum of every
    expert's GLU FFN [T, D] (x dtype, float32 sums)."""
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
    why = cuda_refusal(activation)
    if why is not None:
        raise ValueError(f"moe_experts: {why}")
    ops = [x, gates, wg, wu, wd]
    check_cuda_operands("moe_experts", x.dtype, *ops)
    if any(o.dtype != x.dtype for o in ops):
        raise TypeError("moe_experts: operands must share the x dtype")
    out = torch.empty((t, d), dtype=x.dtype, device=x.device)
    if t == 0:
        return out
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if x.dtype == torch.bfloat16:
        mode, f_per_split, splits = moe_plan(t, f)
    else:
        mode, f_per_split, splits = 1, f, 1
    nbytes, layout = workspace_layout(t, d, f, e, x.dtype, mode, splits)
    ws = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    ptr = {k: ws.data_ptr() + off for k, (off, _, _) in layout.items()}
    operands = (x.data_ptr(), gates.data_ptr(), wg.data_ptr(),
                wu.data_ptr(), wd.data_ptr(), ptr.get("idx"),
                ptr.get("counts"), ptr.get("h"), ptr["part"], out.data_ptr())
    if x.dtype == torch.bfloat16:
        aligned = (d % 16 == 0 and f % 16 == 0
                   and all(o.data_ptr() % 16 == 0 for o in (x, wg, wu, wd)))
        status = _entry(x.dtype)(*operands, t, d, f, e, mode, f_per_split,
                                 splits, int(aligned), stream)
    else:
        status = _entry(x.dtype)(*operands, t, d, f, e, stream)
    check_launch("moe_experts", status)
    moe_experts.launches += 1
    return out


moe_experts.launches = 0
