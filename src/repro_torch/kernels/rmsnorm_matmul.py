"""Fused RMSNorm -> matmul (the plan's ``qkv`` stage, and the final norm
and LM head of the RMSNorm configs on the kernel plan).

``rmsnorm_matmul`` launches ``csrc/rmsnorm_matmul.cu`` on a CUDA tensor and
runs ``ref.rmsnorm_matmul`` on a CPU tensor; ``rmsnorm_matmul_w8`` is its
weight-only int8 twin (``ref.rmsnorm_matmul_w8``).  bfloat16 runs on the
tensor cores with K5's plan (``mma_plan``) and split-K workspace, float32 on
the CUDA cores (``split_plan``), which keeps float32 products exact.
``.launches`` on each counts its calls on the card, one per call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .block_matmul import _workspace
from .common import (MMA_BN, MMA_CFG, ROW_INVARIANT_T, cdiv,
                     check_cuda_operands, check_launch, gemm_smem,
                     kernel_path, mma_class, mma_plan, round_up, sm_count,
                     split_plan, tiled_smem)

# The autotuner's candidate lattice, the reference's
# (``repro/kernels/rmsnorm_matmul.py:25``).  ``CARD_BLOCKS``: the names that
# change what the card runs, per compute dtype.  None: the wrappers take no
# block, K5's ``mma_plan`` (bf16) and ``split_plan`` (float32) decide.
TUNE_SPACE = {"block_t": (128, 256, 512), "block_n": (128, 256, 512)}
CARD_BLOCKS = {"bfloat16": (), "float32": ()}

def smem_bytes(t: int, dtype: torch.dtype, w8: bool = False) -> dict:
    """{kernel: static + dynamic shared memory per block} of a call at
    ``t`` rows (K3, or K10a with ``w8``).  bf16: ``rmsnorm_mma_kernel`` in
    its tile class, the GEMM's ring (``gemm_smem``) beside its static
    rstd rows, the classes up to 64 rows' per-warp sums and the arrival
    flag; above 64 rows the row pass first (none).  float32: the tiled
    kernel with the norm."""
    if dtype != torch.bfloat16:
        return tiled_smem(t, w8=w8, norm=True)
    bm, _ = mma_class(t)
    warps = {16: 4, 64: 4, 128: 8}[bm]
    static = 4 * bm + (4 * warps * bm if bm <= ROW_INVARIANT_T else 0) + 4
    out = {f"rmsnorm_mma_kernel<{MMA_CFG[bm]}, {2 if w8 else 1}>":
           round_up(static, 16) + gemm_smem(bm, norm=True, w8=w8)}
    if t > ROW_INVARIANT_T:
        out["rmsnorm_rstd_kernel"] = 0
    return out


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, w8: bool):
    lib = _build.load("rmsnorm_matmul")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if dtype == torch.bfloat16:
        sym = f"repro_rmsnorm_matmul_{'w8_' if w8 else ''}mma_bf16"
        return _build.declare(lib, sym, [vp] * 8 + [i] * 6 + [f, vp])
    sym = f"repro_rmsnorm_matmul_{'w8_' if w8 else ''}f32"
    return _build.declare(lib, sym, [vp] * (6 if w8 else 5)
                          + [i] * 6 + [f, vp])


def _check(name: str, x, scale, w) -> None:
    if (x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]
            or tuple(scale.shape) != (x.shape[1],)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, w {tuple(w.shape)}")


def _launch(name, x, scale, w, w_scale, eps) -> torch.Tensor:
    t, d = x.shape
    n = w.shape[1]
    out = torch.empty((t, n), dtype=x.dtype, device=x.device)
    sms = sm_count(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    w8 = w_scale is not None
    ws = w_scale.data_ptr() if w8 else None
    if x.dtype == torch.bfloat16:
        bm, _, k_per_split, splits = mma_plan(t, d, n, sms)
        part = ctr = None
        if splits > 1:
            part, ctr = _workspace(x.device, splits * t * n,
                                   cdiv(n, MMA_BN) * cdiv(t, bm))
        # Above ROW_INVARIANT_T rows a row pass writes each row's rstd.
        rstd = (torch.empty(t, dtype=torch.float32, device=x.device)
                if t > ROW_INVARIANT_T else None)
        xp, sp, wp = x.data_ptr(), scale.data_ptr(), w.data_ptr()
        aligned = (d % 8 == 0 and n % (16 if w8 else 8) == 0
                   and xp % 16 == 0 and sp % 16 == 0 and wp % 16 == 0)
        status = _entry(x.dtype, w8)(
            xp, sp, wp, ws, out.data_ptr(),
            part.data_ptr() if part is not None else None,
            ctr.data_ptr() if ctr is not None else None,
            rstd.data_ptr() if rstd is not None else None, t, d, n,
            k_per_split, splits, int(aligned), float(eps), stream)
    else:
        small, k_per_split, splits = split_plan(t, d, n, sms)
        part = (torch.empty((splits, t, n), dtype=torch.float32,
                            device=x.device) if splits > 1 else None)
        ptrs = [x.data_ptr(), scale.data_ptr(), w.data_ptr()]
        if w8:
            ptrs.append(ws)
        status = _entry(x.dtype, w8)(
            *ptrs, out.data_ptr(),
            part.data_ptr() if part is not None else None, t, d, n,
            int(small), k_per_split, splits, float(eps), stream)
    check_launch(name, status)
    return out


def rmsnorm_matmul(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                   *, eps: float = 1e-6) -> torch.Tensor:
    """x [T, D]; scale [D]; w [D, N] -> rms_norm(x) @ w [T, N] (x dtype).
    The CUDA kernel picks its own tiles."""
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
