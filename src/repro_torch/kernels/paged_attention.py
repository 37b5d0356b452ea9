"""Paged attention: single-token decode (the plan's ``decode_attn``) and
the speculative verify window (``verify_attn``), over full-precision pools
or over int8 / fp8-e4m3 code pools with per-(page, KV head) scales.

Every wrapper launches the one window kernel in ``csrc/paged_attention.cuh``
(built one head dim a library: ``paged_attention.cu`` at 128,
``paged_attention_64.cu``, ``paged_attention_80.cu``, and at 320
``paged_attention_320.cu`` and, over codes, ``paged_attention_q320.cu``)
on a CUDA tensor (decode is the window at W = 1; the ``_q`` twins read
code pools) and runs its plain version (``ref.paged_decode_attention`` /
``ref.paged_verify_attention``, with scales for the twins) on a CPU
tensor; ``.launches`` on each counts its own calls of the kernel (one per
call: the split kernel and the fold of its partitions).  The kernel splits
a slot's keys into ``common.paged_plan(extent)`` partitions of
``PAGED_PART`` positions; the wrapper allocates their float32 partials
per call.  The CUDA kernel covers what the main paths run: head dim 64 for
gpt2, 128 for llama3 or 320 for gemma3, with or without a sliding
window (gemma3's local layers) over full-precision and code pools alike,
and for decode also 80 for zamba2's shared block, up to ``MAX_ROWS``
window rows x query heads per KV head (``MAX_ROWS_320`` at head dim 320);
on the card the rest is refused until a slice whose config needs it adds
it.  The plain versions cover it all.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build, ref
from .common import (CODE_DTYPES, PAGED_PART, check_cuda_operands,
                     check_launch, kernel_path, paged_plan)

HEAD_DIMS = (64, 128, 320)     # the CUDA kernel's head dims (verify)
DECODE_HEAD_DIMS = (64, 80, 128, 320)    # ... and decode's (K1, K9a)
MAX_ROWS = 64             # window rows x query heads per KV head it holds
MAX_ROWS_320 = 32         # ... at head dim 320 (registers; codes too)
_NWARP = 4                # warps per block (csrc/paged_attention.cuh)
_CH = 32                  # positions per K/V tile
# Template names of the element types in the kernel's instances.
_TYPE_NAMES = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16",
               torch.int8: "signed char",
               torch.float8_e4m3fn: "__nv_fp8_e4m3"}


def cuda_refusal(d: int, rows: int, verify: bool) -> Optional[str]:
    """Why the CUDA build refuses a call at head dim ``d`` with ``rows``
    window rows x query heads per KV head (decode: the heads alone), or
    None when it runs it.  The wrappers raise with it; the static checks
    report it (``analysis/kernel_lint.py``)."""
    dims = HEAD_DIMS if verify else DECODE_HEAD_DIMS
    max_rows = MAX_ROWS_320 if d == 320 else MAX_ROWS
    if d not in dims or rows > max_rows:
        return (f"the CUDA kernel runs head dims {dims}, up to {max_rows} "
                "window rows x query heads per KV head, any window; got "
                f"head dim {d}, {rows} rows")
    return None


def rows_per_warp(rows: int) -> int:
    """The kernel instance's rows per warp: the fewest of 1, 2, 4, 8, 16
    that hold a block's ``rows`` (``paged_attention.cuh::launch_d``)."""
    return next(r for r in (1, 2, 4, 8, 16) if rows <= _NWARP * r)


def smem_bytes(d: int, rows: int, dtype: torch.dtype,
               code: Optional[torch.dtype] = None) -> dict:
    """{kernel: shared memory per block} of a call at head dim ``d`` with
    ``rows`` rows per block (``cuda_refusal``), q in ``dtype`` and pools of
    ``code`` (None: q's dtype), as ``paged_attention.cuh::smem_bytes``:
    the K/V ring (4 stages of 32-position tiles, 2 where 4 would pass
    168 KB; rows at an odd 16-byte stride), q and p rows, each position's
    page offset and scales.  No static arrays; the fold of the
    partitions takes none.  The page size does not enter.  Empty for a
    block of more rows than any instance holds (the wrapper refuses it)."""
    if rows > (MAX_ROWS_320 if d == 320 else MAX_ROWS):
        return {}
    pool = code or dtype
    csize = torch.tensor([], dtype=pool).element_size()
    rv = d // (16 // csize)
    tile = _CH * (rv | 1) * 16
    stages = 4 if 8 * tile <= 168 * 1024 else 2
    rpw = rows_per_warp(rows)
    block_rows = _NWARP * rpw
    nbytes = (stages * 2 * tile + 4 * block_rows * d + 4 * block_rows * _CH
              + 8 * PAGED_PART + 2 * 4 * PAGED_PART)
    t, c = _TYPE_NAMES[dtype], _TYPE_NAMES[pool]
    return {f"paged_window_kernel<{t}, {c}, {d}, {rpw}>": nbytes,
            f"paged_combine_kernel<{t}, {d}>": 0}


# Each head dim's instances build in a library of their own, so that the
# sources compile side by side: (library, symbol prefix) per head dim;
# at head dim 320 the code twins in ``paged_attention_q320``.
_LIBRARIES = {64: ("paged_attention_64", "d64_"),
              80: ("paged_attention_80", "d80_"),
              128: ("paged_attention", ""),
              320: ("paged_attention_320", "d320_")}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, code: Optional[torch.dtype] = None,
           head_dim: int = 128):
    """``code``: None for full-precision pools, else the pools' code type;
    ``head_dim``: which library (``_LIBRARIES``)."""
    source, d = _LIBRARIES[head_dim]
    if head_dim == 320 and code is not None:
        source = "paged_attention_q320"
    lib = _build.load(source)
    tname = "bf16" if dtype == torch.bfloat16 else "f32"
    vp, i = ctypes.c_void_p, ctypes.c_int
    # Ten ints (the shape, the partition, the sliding window), the scale.
    ints = [i] * 10 + [ctypes.c_float, vp]
    if code is None:
        return _build.declare(lib, f"repro_paged_window_{d}{tname}",
                              [vp] * 7 + ints)
    return _build.declare(
        lib, f"repro_paged_window_q_{d}{tname}_{CODE_DTYPES[code]}",
        [vp] * 9 + ints)


def _check_shapes(name, q, k_pool, v_pool, page_table, base) -> None:
    b, _, hq, d = q.shape
    _, _, hkv, d2 = k_pool.shape
    if (d != d2 or tuple(v_pool.shape) != tuple(k_pool.shape) or hq % hkv
            or page_table.dim() != 2 or page_table.shape[0] != b
            or tuple(base.shape) != (b,)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(page_table.shape)}, per-slot operand "
                         f"{tuple(base.shape)}")


def _launch(name, q, k_pool, v_pool, page_table, base, *, extra: int,
            window: int, scale: float, k_scale=None,
            v_scale=None) -> torch.Tensor:
    """Launch the window kernel: row w of slot b sees ``base[b] + w +
    extra`` positions (the last ``window`` of them when ``window`` > 0).
    With ``k_scale``/``v_scale`` the pools hold codes; ``extra`` 1 is the
    verify entry point (``cuda_refusal``)."""
    verify = bool(extra)
    quant = k_scale is not None
    scales = (k_scale, v_scale) if quant else ()
    check_cuda_operands(name, q.dtype, q, k_pool, v_pool, page_table, base,
                        *scales)
    code = k_pool.dtype if quant else q.dtype
    if quant and (code not in CODE_DTYPES
                  or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32
                  or tuple(k_scale.shape) != tuple(k_pool.shape[::2])
                  or tuple(v_scale.shape) != tuple(k_pool.shape[::2])):
        raise TypeError(f"{name}: code pools must be int8 or float8_e4m3fn "
                        "with float32 scales [P, Hkv]; got "
                        f"{k_pool.dtype}, scales {k_scale.dtype} "
                        f"{tuple(k_scale.shape)}")
    if k_pool.dtype != code or v_pool.dtype != code:
        raise TypeError(f"{name}: the K and V pools must share a dtype"
                        + ("" if quant else " with q"))
    if page_table.dtype != torch.int32 or base.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and the per-slot operand must "
                        "be int32")
    b, w, hq, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    g = hq // hkv
    why = cuda_refusal(d, w * g, verify)
    if why is not None or window < 0:
        raise ValueError(f"{name}: {why or f'window {window}'}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel copies pool rows in 16-byte "
                         "vectors; the pools must start at 16-byte aligned "
                         "addresses")
    maxp = page_table.shape[1]
    # The partitions' float32 (acc [D], m, l) per output row.
    part = torch.empty(b * w * hq * paged_plan(maxp * ps) * (d + 2),
                       dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr()]
    ptrs += [t.data_ptr() for t in scales]
    ptrs += [page_table.data_ptr(), base.data_ptr(), part.data_ptr(),
             out.data_ptr()]
    ints = [b, hkv, g, w, extra, d, ps, maxp, PAGED_PART, int(window)]
    status = _entry(q.dtype, code if quant else None, d)(
        *ptrs, *ints, float(scale), stream)
    check_launch(name, status)
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q [B, 1, Hq, D]; pools [P, ps, Hkv, D]; page_table [B, maxp] int32
    (valid page ids, NULL page 0 where unallocated); lengths [B] int32
    valid entries per slot -> [B, 1, Hq, D].  Length 0 gives zeros."""
    _check_shapes("paged_decode_attention", q, k_pool, v_pool, page_table,
                  lengths)
    if q.shape[1] != 1:
        raise ValueError("paged_decode_attention: q must hold one token per "
                         f"slot, got {tuple(q.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kernel_path(q) == "plain":
        return ref.paged_decode_attention(q, k_pool, v_pool, page_table,
                                          lengths, window=window,
                                          scale=scale)
    out = _launch("paged_decode_attention", q, k_pool, v_pool, page_table,
                  lengths, extra=0, window=window, scale=scale)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           q_off: torch.Tensor, *, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """W-token speculative-verify attention against paged K/V pools.

    q [B, W, Hq, D], the pending token and W - 1 drafts per slot; pools
    [P, ps, Hkv, D]; page_table [B, maxp] int32; q_off [B] int32 the
    absolute position of window row 0, so row i attends to the first
    ``q_off + i + 1`` positions -> [B, W, Hq, D].  Row i equals
    ``paged_decode_attention`` at length ``q_off + i + 1``: bit for bit on
    the card, where both run one device function."""
    _check_shapes("paged_verify_attention", q, k_pool, v_pool, page_table,
                  q_off)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kernel_path(q) == "plain":
        return ref.paged_verify_attention(q, k_pool, v_pool, page_table,
                                          q_off, window=window, scale=scale)
    out = _launch("paged_verify_attention", q, k_pool, v_pool, page_table,
                  q_off, extra=1, window=window, scale=scale)
    paged_verify_attention.launches += 1
    return out


paged_verify_attention.launches = 0


def paged_decode_attention_q(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, page_table: torch.Tensor,
                             lengths: torch.Tensor, *,
                             k_scale: torch.Tensor, v_scale: torch.Tensor,
                             window: int = 0,
                             scale: Optional[float] = None) -> torch.Tensor:
    """``paged_decode_attention`` over quantized pools (K9a): k/v pools
    [P, ps, Hkv, D] int8 or float8_e4m3fn codes, ``k_scale``/``v_scale``
    [P, Hkv] float32; each page is dequantized at its scale before the
    products."""
    _check_shapes("paged_decode_attention_q", q, k_pool, v_pool, page_table,
                  lengths)
    if q.shape[1] != 1:
        raise ValueError("paged_decode_attention_q: q must hold one token "
                         f"per slot, got {tuple(q.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kernel_path(q) == "plain":
        return ref.paged_decode_attention(q, k_pool, v_pool, page_table,
                                          lengths, window=window,
                                          scale=scale, k_scale=k_scale,
                                          v_scale=v_scale)
    out = _launch("paged_decode_attention_q", q, k_pool, v_pool, page_table,
                  lengths, extra=0, window=window, scale=scale,
                  k_scale=k_scale, v_scale=v_scale)
    paged_decode_attention_q.launches += 1
    return out


paged_decode_attention_q.launches = 0


def paged_verify_attention_q(q: torch.Tensor, k_pool: torch.Tensor,
                             v_pool: torch.Tensor, page_table: torch.Tensor,
                             q_off: torch.Tensor, *, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, window: int = 0,
                             scale: Optional[float] = None) -> torch.Tensor:
    """``paged_verify_attention`` over quantized pools (K9b), with the
    pools and scales of ``paged_decode_attention_q``.  Row i equals
    ``paged_decode_attention_q`` at length ``q_off + i + 1``: bit for bit
    on the card, where both run one device function."""
    _check_shapes("paged_verify_attention_q", q, k_pool, v_pool, page_table,
                  q_off)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kernel_path(q) == "plain":
        return ref.paged_verify_attention(q, k_pool, v_pool, page_table,
                                          q_off, window=window, scale=scale,
                                          k_scale=k_scale, v_scale=v_scale)
    out = _launch("paged_verify_attention_q", q, k_pool, v_pool, page_table,
                  q_off, extra=1, window=window, scale=scale,
                  k_scale=k_scale, v_scale=v_scale)
    paged_verify_attention_q.launches += 1
    return out


paged_verify_attention_q.launches = 0
