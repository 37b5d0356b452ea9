"""Device resolution and block-size helpers shared by the kernel wrappers.

Every kernel wrapper in this package follows one contract: a tensor that
lies on the CPU runs the kernel's plain PyTorch version (``ref.py``); a
tensor on a CUDA device launches the hand-written Hopper kernel or raises.
There is no fallback from one to the other.  Block sizes from the
StreamPlan are hints: they never change the math (DESIGN.md §16).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]
# The quantized kernels' code types and their entry-point suffixes.
CODE_DTYPES = {torch.int8: "i8", torch.float8_e4m3fn: "fp8"}


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, queried once per device."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


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


# Mirrors the tile shapes of csrc/tiled_matmul.cuh (K3, K10a, K11 and K5
# in float32).
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


# Mirrors the tile classes of csrc/mma_gemm.cuh's tensor-core GEMM (K5, K3
# and K10a in bf16; K11's token tiles are its Large class): (rows up to,
# BM, BK); BN is 128 in every class.
MMA_CLASSES = ((16, 16, 64), (ROW_INVARIANT_T, 64, 64), (None, 128, 64))
MMA_BN = 128


@functools.lru_cache(maxsize=4096)
def mma_plan(m: int, k: int, n: int, sms: int):
    """(bm, bk, k_per_split, splits) for the tensor-core ``block_matmul``
    and ``rmsnorm_matmul`` (and its int8 twin).
    Up to ``ROW_INVARIANT_T`` rows (the 16- and 64-row classes, both
    64-deep K tiles) the split depends on (k, n) alone: K is cut until the
    grid holds about one block per SM, keeping >= 2 K tiles per split
    (more splits cost more in the last block's sum than they gain in
    parallel loads), so a row's float32 sums are the same at every such
    row count.  Larger M (128 x 128 tiles) splits only to fill one wave,
    keeping >= 4 K tiles per split.  Splits cover K in whole K tiles.
    Cached: it runs on every decode-step call."""
    bm, bk = next((bm, bk) for top, bm, bk in MMA_CLASSES
                  if top is None or m <= top)
    ktiles = cdiv(k, bk)
    if m <= ROW_INVARIANT_T:
        want = min(cdiv(sms, cdiv(n, MMA_BN)), ktiles // 2)
    else:
        want = min(cdiv(sms, cdiv(n, MMA_BN) * cdiv(m, bm)), ktiles // 4)
    k_per_split = max(1, cdiv(ktiles, max(1, want))) * bk
    return bm, bk, k_per_split, max(1, cdiv(k, k_per_split))


# Mirrors csrc/streamed_ffn.cu's tensor-core kernel (K4, K6, K10b, K10c in
# bf16): the fused launch's blocks own whole 128-column h tiles (at most
# FFN_MAX_TILES); the two-pass kernels make 64-column h tiles (h's rows
# padded to a multiple of 64) and split the down product's F rows in
# 64-deep tiles over [64, 128] output tiles.
FFN_FUSED_BF = 128
FFN_MAX_TILES = 2
FFN_BF = 64
FFN_BN = 128
FFN_BT = 64


@functools.lru_cache(maxsize=4096)
def ffn_plan(t: int, d: int, f: int, sms: int):
    """(mode, f_per_split, splits) for the tensor-core streamed FFN.

    Up to ``ROW_INVARIANT_T`` rows, mode 0 (one fused launch): the F
    columns are cut into ``splits`` ranges of ``f_per_split`` (whole h
    tiles), about one block per SM, from (d, f, sms) alone, so a row runs
    the same products and sums the same partials in the same order at
    every such row count.  Above, mode 1 (two passes through an h [T, F]
    in HBM): the down product's F rows are split only while its [64, 128]
    output tiles fill less than two blocks per SM, keeping >= 4 F tiles per
    split and the partials' traffic (2 x splits x T x D x 4 bytes) within
    2 D F bytes, less than every instance's weight bytes.  Cached: it runs
    on every decode-step call."""
    if t <= ROW_INVARIANT_T:
        tiles = cdiv(f, FFN_FUSED_BF)
        per = min(FFN_MAX_TILES, cdiv(tiles, sms))
        f_per_split = per * FFN_FUSED_BF
        return 0, f_per_split, cdiv(f, f_per_split)
    tiles = cdiv(f, FFN_BF)
    out_tiles = cdiv(d, FFN_BN) * cdiv(t, FFN_BT)
    want = max(1, min(cdiv(2 * sms, out_tiles), tiles // 4, f // (4 * t)))
    f_per_split = cdiv(tiles, want) * FFN_BF
    return 1, f_per_split, cdiv(f, f_per_split)


# Mirrors csrc/moe_experts.cu's bf16 launches (K12): up to 64 rows each
# fused block owns MOE_BF columns of one expert's F; the two passes make
# 64-column h tiles (h's rows padded to a multiple of FFN_BF).
MOE_BF = 128


@functools.lru_cache(maxsize=4096)
def moe_plan(t: int, f: int):
    """(mode, f_per_split, splits) for the tensor-core MoE experts.

    Up to ``ROW_INVARIANT_T`` rows, mode 0 (one fused launch over (F range,
    expert)): F cut into ranges of ``MOE_BF`` columns, from f alone, so a
    (token, expert) pair runs the same products and sums the same partials
    in the same order at every such row count, however many tokens its
    expert keeps.  Above, mode 1 (two passes through an h [E, T, F] in
    HBM, one split).  Cached: it runs on every decode-step call."""
    if t <= ROW_INVARIANT_T:
        return 0, MOE_BF, cdiv(f, MOE_BF)
    return 1, f, 1


# Mirrors csrc/paged_attention.cu's split of a slot's keys (K1, K8, K9a,
# K9b): block (slot, KV head, p) owns positions [p P, (p + 1) P) of the
# slot's page-table extent, P = PAGED_PART, a multiple of the 16-token
# page and of the kernel's 32-position tile.
PAGED_PART = 128


def paged_plan(extent: int) -> int:
    """Partitions of a slot's page-table extent (``maxp * page_size``
    positions) for the paged attention kernels: ``cdiv(extent,
    PAGED_PART)``.  The partition size is one constant, never a function
    of the lengths, the window, the batch or the card: a row's float32
    operations then depend on its length alone, which keeps every verify
    row bit-equal to decode at its length and a slot's bits independent
    of the other slots."""
    return cdiv(extent, PAGED_PART)


# Mirrors csrc/mamba2_scan.cu's bf16 sequence-split scan (K13): segments of
# SSD_SEG rows counted from position 0.
SSD_SEG = 64


def ssd_plan(s: int):
    """(segment rows, segments) of the bf16 SSD scan over ``s`` positions:
    segments of ``SSD_SEG`` rows from position 0, the last one partial
    where ``SSD_SEG`` does not divide ``s`` (its rows at or past ``s``
    masked).  From ``s`` alone, never from the caller's chunk or the
    batch: a row's bits then depend on the rows before it alone, at every
    prompt length, chunk and batch."""
    return SSD_SEG, cdiv(s, SSD_SEG)


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


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it at a 16-byte aligned address: the
    tensor-core kernels read rows with 16-byte copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_launch(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point: a
    refused launch never runs, and a later synchronize does not report it."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {status})")
