"""Streamed cross-entropy (the plan's ``lm_head`` stage on the training
path): the LM head's logits folded into (logsumexp, gold logit) per token
without the ``[T, Vp]`` logits ever reaching device memory.

``streamed_xent_parts`` launches ``csrc/streamed_xent.cu`` on a CUDA tensor
(bfloat16 on the tensor cores, ``xent_mma_plan``; float32 on the CUDA cores,
``vocab_split``) and runs ``ref.xent_parts_ref`` on a CPU tensor;
``streamed_xent_loss`` is
the mean over the valid labels on top of it, as the reference wrapper
(``streamed_xent.py:112``).  ``streamed_xent_parts.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build, ref
from .common import (MMA_BN, cdiv, check_cuda_operands, check_launch,
                     gemm_smem, kernel_path, sm_count)

# Mirrors the tile shapes of csrc/streamed_xent.cu: float32 64 x 64 (token
# x vocab), bfloat16 128 x 128 (the Large class of mma_gemm.cuh).
_BT, _BN = 64, 64
MMA_BT = 128


def smem_bytes(dtype: torch.dtype) -> dict:
    """{kernel: static + dynamic shared memory per block} of a call (the
    same at every shape).  bf16: ``xent_mma_kernel`` runs mma_gemm.cuh's
    128-row class (``gemm_smem``) beside its static per-warp row maxima,
    sums, gold logits and labels; float32: the CUDA-core kernel's x and W
    tiles.  The merge of the vocab splits takes none."""
    if dtype == torch.bfloat16:
        static = 4 * (2 * MMA_BT * 4 + 2 * MMA_BT)
        return {"xent_mma_kernel": static + gemm_smem(MMA_BT),
                "xent_merge_kernel": 0}
    return {"xent_parts_kernel": 4 * (32 * (_BT + 1) + 32 * _BN),
            "xent_merge_kernel": 0}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("streamed_xent")
    vp, i = ctypes.c_void_p, ctypes.c_int
    if dtype == torch.bfloat16:
        return _build.declare(lib, "repro_streamed_xent_mma_bf16",
                              [vp] * 6 + [i] * 7 + [vp])
    return _build.declare(lib, "repro_streamed_xent_f32",
                          [vp] * 6 + [i] * 6 + [vp])


def vocab_split(t: int, vp: int, sms: int) -> Tuple[int, int]:
    """(tiles_per_split, splits): cut the vocab tiles into contiguous
    ranges until the grid holds about four blocks per SM (the token tiles
    alone give 64 blocks at 4096 tokens); every split gets at least one
    tile."""
    n_tiles = cdiv(vp, _BN)
    want = max(1, min(n_tiles, cdiv(4 * sms, cdiv(t, _BT))))
    per = cdiv(n_tiles, want)
    return per, cdiv(n_tiles, per)


def xent_mma_plan(t: int, vp: int, sms: int) -> Tuple[int, int]:
    """(tiles_per_split, splits) for the bf16 kernel: cut the 128-column
    vocab tiles into contiguous ranges until the grid holds about eight
    blocks per SM (four waves at two per SM; 32 token tiles at 4096
    tokens); every split gets at least one tile.  The partials are 12
    bytes per row and split, so splitting costs nothing in memory."""
    n_tiles = cdiv(vp, MMA_BN)
    want = max(1, min(n_tiles, cdiv(8 * sms, cdiv(t, MMA_BT))))
    per = cdiv(n_tiles, want)
    return per, cdiv(n_tiles, per)


def streamed_xent_parts(hidden: torch.Tensor, head: torch.Tensor,
                        labels: torch.Tensor, *, vocab_size: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden [T, D]; head [D, Vp]; labels [T] int in [0, Vp) -> (lse [T],
    gold [T]) float32.  Columns ``v >= vocab_size`` are masked to -1e30;
    the logits sum in float32 from the bf16 or f32 operands."""
    t, d = hidden.shape
    d2, vp = head.shape
    if d != d2 or tuple(labels.shape) != (t,):
        raise ValueError(f"streamed_xent: hidden {tuple(hidden.shape)}, "
                         f"head {tuple(head.shape)}, labels "
                         f"{tuple(labels.shape)}")
    if kernel_path(hidden) == "plain":
        return ref.xent_parts_ref(hidden, head, labels, vocab_size)
    check_cuda_operands("streamed_xent", hidden.dtype, hidden, head, labels)
    if head.dtype != hidden.dtype or labels.dtype != torch.int32:
        raise TypeError("streamed_xent: hidden and head must share a dtype "
                        f"and labels be int32; got {hidden.dtype}, "
                        f"{head.dtype}, {labels.dtype}")
    dev = hidden.device
    lse = torch.empty(t, dtype=torch.float32, device=dev)
    gold = torch.empty(t, dtype=torch.float32, device=dev)
    mma = hidden.dtype == torch.bfloat16
    per, splits = (xent_mma_plan if mma else vocab_split)(t, vp,
                                                          sm_count(dev))
    part = torch.empty((3, splits, t), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    hp, wp = hidden.data_ptr(), head.data_ptr()
    args = [hp, wp, labels.data_ptr(), lse.data_ptr(), gold.data_ptr(),
            part.data_ptr(), t, d, vp, int(vocab_size), per, splits]
    if mma:
        args.append(int(d % 8 == 0 and vp % 8 == 0 and hp % 16 == 0
                        and wp % 16 == 0))
    status = _entry(hidden.dtype)(*args, stream)
    check_launch("streamed_xent", status)
    streamed_xent_parts.launches += 1
    return lse, gold


def streamed_xent_loss(hidden: torch.Tensor, head: torch.Tensor,
                       labels: torch.Tensor, *,
                       vocab_size: int) -> torch.Tensor:
    """Mean cross-entropy over ``labels >= 0`` (the ignore index is any
    negative label, -100 by convention), flat token axis."""
    lse, gold = streamed_xent_parts(
        hidden, head, torch.clamp(labels, min=0).to(torch.int32),
        vocab_size=vocab_size)
    return ref.xent_nll_mean(lse, gold, labels)


streamed_xent_parts.launches = 0
