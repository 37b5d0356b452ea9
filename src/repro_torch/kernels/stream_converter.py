"""The stream layout converter (K15): Algorithm 1 on real data.

``convert_layout(data, src, dst)`` streams a 2-D tensor laid out as the
producer's itensor type ``src`` out in the consumer's type ``dst``: the
tile stream [dst.num_tokens, eh, ew] in consumer order, the tiles of
reuse loops repeated.  It checks ``data.shape == src.data_shape`` and
runs ``infer_converter(src, dst)``, which raises on a dtype or data-space
mismatch between the two types, as the reference's ``convert_layout``
(``repro/kernels/stream_converter.py:34``) does.

A CPU tensor runs ``ref.convert_layout_ref``; a contiguous 2-D CUDA
tensor of 1-, 2- or 4-byte elements launches ``csrc/stream_converter.cu``
(one kernel for both of the reference's Pallas bodies, the matching-type
copy and the Algorithm-1 window: they emit the same stream);
``convert_layout.launches`` counts its launches.  ``_plan`` cuts the
output into ranges of ``run`` bytes, one block each: a block decodes the
tokens its range touches (at most ``MAX_TOKENS``) from the descriptor built
here (at most ``MAX_LOOPS`` loops) and writes the range in 16-byte
vectors.  Token counts and data offsets are 32-bit in the kernel, so the
stream may hold fewer than 2^31 tokens and the data fewer than 2^31
elements; the stream's own offsets are 64-bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.converter import infer_converter
from ..core.itensor import ITensorType
from . import _build, ref
from .common import cdiv, check_launch, kernel_path, round_up

MAX_LOOPS = 8
# Tokens one block's range may touch (csrc MAXT: an int32 offset each in
# shared memory).
MAX_TOKENS = 2048
# Bytes per block: enough blocks to fill the card (a few per SM) on small
# streams, 32 KB (8 vectors a thread) on large ones.
RUN_MIN, RUN_MAX = 4096, 32768
_BLOCKS_PER_SM = 4
_I32 = 1 << 31


class _Desc(ctypes.Structure):
    """Mirrors ``Desc`` in ``csrc/stream_converter.cu``."""
    _fields_ = [("total", ctypes.c_int64), ("n_tokens", ctypes.c_int64),
                ("row", ctypes.c_int32), ("nloops", ctypes.c_int32),
                ("eh", ctypes.c_int32), ("ew", ctypes.c_int32),
                ("vec", ctypes.c_int32), ("run", ctypes.c_int32),
                ("trip", ctypes.c_int32 * MAX_LOOPS),
                ("ch", ctypes.c_int32 * MAX_LOOPS),
                ("cw", ctypes.c_int32 * MAX_LOOPS)]


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("stream_converter")
    vp = ctypes.c_void_p
    return _build.declare(lib, "repro_convert_layout",
                          [vp, vp, _Desc, ctypes.c_int, ctypes.c_int, vp])


def _plan(data: torch.Tensor, dst: ITensorType, sms: int):
    """(descriptor, blocks) of the launch that streams ``data`` out in
    ``dst``: ranges of ``run`` bytes, a multiple of 16, one block each."""
    n_loops = dst.iter_rank
    if n_loops > MAX_LOOPS:
        raise ValueError(f"convert_layout: {n_loops} loops; the CUDA kernel "
                         f"takes at most {MAX_LOOPS}")
    n = dst.num_tokens
    if n >= _I32 or data.numel() >= _I32:
        raise ValueError(f"convert_layout: {n} tokens over {data.numel()} "
                         "elements; the CUDA kernel indexes both in 31 bits")
    eh, ew = dst.elem_shape
    rh, rw = dst.iter_map.results
    esz = data.element_size()
    tile_bytes = eh * ew * esz
    total = n * tile_bytes
    run = min(RUN_MAX, max(RUN_MIN, round_up(cdiv(total, _BLOCKS_PER_SM
                                                  * sms), 16)))
    # A range of `run` bytes touches at most run / tile_bytes + 2 tokens.
    run = min(run, (MAX_TOKENS - 2) * tile_bytes // 16 * 16)
    d = _Desc(total=total, n_tokens=n, row=data.shape[1], nloops=n_loops,
              eh=eh, ew=ew, run=run)
    for k, tc in enumerate(dst.tripcounts):
        d.trip[k] = tc
    d.ch[rh] = dst.steps[rh]
    d.cw[rw] = dst.steps[rw]
    # 16-byte loads need every tile row, the row stride, each tile's
    # column offset and the data pointer on 16-byte boundaries.
    d.vec = int(all(x % 16 == 0 for x in (ew * esz, data.shape[1] * esz,
                                          dst.steps[rw] * esz,
                                          data.data_ptr())))
    return d, cdiv(total, run)


def convert_layout(data: torch.Tensor, src: ITensorType,
                   dst: ITensorType) -> torch.Tensor:
    """Stream ``data`` (producer layout ``src``) out in consumer layout
    ``dst``: [dst.num_tokens, *dst.elem_shape] in ``data``'s dtype."""
    if tuple(data.shape) != src.data_shape:
        raise ValueError(f"{tuple(data.shape)} != {src.data_shape}")
    infer_converter(src, dst)
    if len(dst.elem_shape) != 2:
        raise ValueError(f"convert_layout: a 2-D tensor, got elements "
                         f"{dst.elem_shape}")
    if kernel_path(data) == "plain":
        return ref.convert_layout_ref(data, src, dst)
    if not data.is_contiguous():
        raise ValueError("convert_layout: data is not contiguous")
    esz = data.element_size()
    if esz not in (1, 2, 4):
        raise TypeError(f"convert_layout: {data.dtype} ({esz}-byte "
                        "elements); the CUDA kernel copies 1, 2 or 4 bytes")
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    desc, blocks = _plan(data, dst, sms)
    out = torch.empty((dst.num_tokens, *dst.elem_shape), dtype=data.dtype,
                      device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    status = _entry()(data.data_ptr(), out.data_ptr(), desc, esz, blocks,
                      stream)
    check_launch("convert_layout", status)
    convert_layout.launches += 1
    return out


convert_layout.launches = 0
