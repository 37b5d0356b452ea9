"""Tiled matmul (the plan's ``qkv`` stage for the LayerNorm configs, the
o-projection, gpt2's and rwkv6's LM heads, granite's router product).

``block_matmul`` launches ``csrc/block_matmul.cu`` on a CUDA tensor and runs
``ref.block_matmul`` on a CPU tensor: bfloat16 through the tensor-core
kernel (``mma_plan``), float32 through the CUDA-core tiled kernel
(``split_plan``), which keeps float32 products exact.
``block_matmul.launches`` counts kernel launches, one per call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from . import _build, ref
from .common import (MMA_BN, MMA_CFG, cdiv, check_cuda_operands,
                     check_launch, gemm_smem, kernel_path, mma_class,
                     mma_plan, sm_count, split_plan, tiled_smem)

# Per device, the split-K workspace of the tensor-core kernel: float32
# partials [splits, M, N] and one int32 arrival counter per output tile,
# all 0 between launches (the last block on a tile resets its own).  Calls
# on one stream run one after another, so one workspace serves them; it
# grows to the largest split seen (a split runs only while the output tiles
# fill less than a wave, so partials stay under ~17 MB).
_WORKSPACE: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def smem_bytes(m: int, dtype: torch.dtype) -> dict:
    """{kernel: static + dynamic shared memory per block} of a call at
    ``m`` rows: bf16 ``block_mma_kernel`` in its tile class (the GEMM's
    ring, 16 bytes of static arrival flag), float32 the tiled kernel."""
    if dtype == torch.bfloat16:
        bm, _ = mma_class(m)
        return {f"block_mma_kernel<{MMA_CFG[bm]} >": 16 + gemm_smem(bm)}
    return tiled_smem(m)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("block_matmul")
    vp, i = ctypes.c_void_p, ctypes.c_int
    if dtype == torch.bfloat16:
        return _build.declare(lib, "repro_block_matmul_mma_bf16",
                              [vp] * 5 + [i] * 6 + [vp])
    return _build.declare(lib, "repro_block_matmul_f32",
                          [vp] * 4 + [i] * 6 + [vp])


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


def block_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K]; w [K, N] -> x @ w [M, N] (x dtype, float32 sums).  The
    CUDA kernel picks its own tiles."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"block_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if kernel_path(x) == "plain":
        return ref.block_matmul(x, w)
    check_cuda_operands("block_matmul", x.dtype, x, w)
    if w.dtype != x.dtype:
        raise TypeError("block_matmul: x and w must share a dtype")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        bm, _, k_per_split, splits = mma_plan(m, k, n, sm_count(x.device))
        part = ctr = None
        if splits > 1:
            part, ctr = _workspace(x.device, splits * m * n,
                                   cdiv(n, MMA_BN) * cdiv(m, bm))
        xp, wp = x.data_ptr(), w.data_ptr()
        aligned = k % 8 == 0 and n % 8 == 0 and xp % 16 == 0 and wp % 16 == 0
        status = _entry(x.dtype)(
            xp, wp, out.data_ptr(),
            part.data_ptr() if part is not None else None,
            ctr.data_ptr() if ctr is not None else None, m, k, n,
            k_per_split, splits, int(aligned), stream)
    else:
        small, k_per_split, splits = split_plan(m, k, n, sm_count(x.device))
        part = (torch.empty((splits, m, n), dtype=torch.float32,
                            device=x.device) if splits > 1 else None)
        status = _entry(x.dtype)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            part.data_ptr() if part is not None else None, m, k, n,
            int(small), k_per_split, splits, stream)
    check_launch("block_matmul", status)
    block_matmul.launches += 1
    return out


block_matmul.launches = 0
