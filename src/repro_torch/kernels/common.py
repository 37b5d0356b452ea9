"""Device resolution and block-size helpers shared by the kernel wrappers.

Every kernel wrapper in this package follows one contract: a tensor that
lies on the CPU runs the kernel's plain PyTorch version (``ref.py``); a
tensor on a CUDA device launches the hand-written Hopper kernel or raises.
There is no fallback from one to the other.  Block sizes from the
StreamPlan are hints: they never change the math (DESIGN.md §16).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Without a CUDA device that raises: a run
    that asked for the GPU never turns into a CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def on_hopper() -> bool:
    """True on a compute-capability 9.0 card (H100/H200)."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_block(extent: int, target: int, align: int = 128) -> int:
    """Largest aligned block <= target that divides extent; the largest
    divisor <= target when alignment is impossible (small shapes) — the
    reference's tiling policy, used where a plain version mirrors the
    reference kernel's block structure."""
    cap = min(extent, target)
    best = None
    for b in range(cap, 0, -1):
        if extent % b:
            continue
        if b % align == 0:
            return b
        if best is None:
            best = b
    return best or extent


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


# Mirrors the tile shapes of csrc/tiled_matmul.cuh (K3 and K5).
_MATMUL_BK = 32
_MATMUL_SMALL_T = 16      # T <= this: 8 x 128 tiles, else 64 x 64
_MATMUL_TILES = {True: (8, 128), False: (64, 64)}
# Rows up to which a kernel's per-row float32 summation order follows from
# the weight shape alone: 4 slots x a 16-row verify window.  A speculative
# verify dispatch (slots x W rows) then gives each row the bits a decode
# step (slots rows) gives it, which exact acceptance needs.
ROW_INVARIANT_T = 64


def split_plan(t: int, d: int, n: int, sms: int):
    """(small, k_per_split, splits) for the split-K tiled matmul: split K
    across blocks until the grid holds about two blocks per SM, keeping
    >= 4 K tiles per split.  Each output sums its K products in order
    within a split, then the splits in order, whatever the tile shape; up
    to ``ROW_INVARIANT_T`` rows the split is sized for one row tile, so
    it depends on (d, n) alone."""
    small = t <= _MATMUL_SMALL_T
    rows = 1 if t <= ROW_INVARIANT_T else t
    bt, bn = _MATMUL_TILES[rows <= _MATMUL_SMALL_T]
    tiles = cdiv(n, bn) * cdiv(rows, bt)
    want = max(1, min(cdiv(2 * sms, tiles), d // (4 * _MATMUL_BK)))
    k_per_split = cdiv(cdiv(d, want), _MATMUL_BK) * _MATMUL_BK
    return small, k_per_split, cdiv(d, k_per_split)


def kernel_path(t: torch.Tensor) -> str:
    """'plain' for a CPU tensor, 'cuda' for a CUDA tensor; anything else
    (meta, mps, ...) is refused."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"unsupported device {t.device} for a repro_torch kernel")


def check_cuda_operands(name: str, dtype: torch.dtype, *tensors) -> None:
    """Launch preconditions shared by every wrapper: one CUDA device,
    contiguous, the kernel's compute dtype (float32 or bfloat16)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} "
                             "is not contiguous")


def check_launch(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point: a
    refused launch never runs, and a later synchronize does not report it."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {status})")
