"""The Mamba2 chunked SSD scan (the plan's ``mixer``, K13).

``mamba2_ssd`` launches ``csrc/mamba2_scan.cu`` on a CUDA tensor and runs
``ref.mamba2_ssd`` on a CPU tensor; ``mamba2_ssd.launches`` counts kernel
launches.  The CUDA kernel takes any chunk Q that divides S (the model
asks for the largest divisor of S up to 128, so an odd prompt scans in
chunks of 1) and reads B and C, one group shared by every head, in place.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path

# Shared memory one block may use on Hopper (227 KB).
MAX_SMEM = 232_448


def smem_bytes(q: int, p: int, n: int) -> int:
    """Dynamic shared memory of one block (csrc/mamba2_scan.cu): the
    chunk's x [Q, P], B and C [Q, N + 1], the masked (C B^T) o L [Q, Q],
    the state [P, N + 1] and three [Q] vectors, all float32."""
    return 4 * (q * p + 2 * q * (n + 1) + q * q + p * (n + 1) + 3 * q)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("mamba2_scan")
    sym = ("repro_mamba2_ssd_bf16" if dtype == torch.bfloat16
           else "repro_mamba2_ssd_f32")
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp] * 8 + [i] * 6 + [vp])


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
               chunk: int = 128):
    """x [B, S, H, P]; dt [B, S, H]; a_log [H]; b/c [B, S, N]; d_skip [H]
    -> (y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32),
    in chunks of ``min(chunk, S)`` rows, which must divide S."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if (tuple(dt.shape) != (bsz, s, h) or tuple(b.shape) != (bsz, s, n)
            or tuple(c.shape) != (bsz, s, n) or tuple(a_log.shape) != (h,)
            or tuple(d_skip.shape) != (h,) or q < 1 or s % q):
        raise ValueError(f"mamba2_ssd: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, a_log {tuple(a_log.shape)}, "
                         f"d_skip {tuple(d_skip.shape)}, chunk {chunk}")
    if kernel_path(x) == "plain":
        return ref.mamba2_ssd(x, dt, a_log, b, c, d_skip, chunk=chunk)
    check_cuda_operands("mamba2_ssd", x.dtype, x, dt, b, c, a_log, d_skip)
    if any(t.dtype != x.dtype for t in (dt, b, c)):
        raise TypeError("mamba2_ssd: x, dt, b and c must share a dtype")
    if smem_bytes(q, p, n) > MAX_SMEM:
        raise ValueError(f"mamba2_ssd: chunk {q} with P {p}, N {n} needs "
                         f"{smem_bytes(q, p, n)} bytes of shared memory")
    # The per-head constants, as the reference wrapper prepares them.
    a = -torch.exp(a_log.float())
    d = d_skip.float()
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _entry(x.dtype)(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), d.data_ptr(), y.data_ptr(), state.data_ptr(), bsz, s,
        h, p, n, q, stream)
    check_launch("mamba2_ssd", status)
    mamba2_ssd.launches += 1
    return y, state


mamba2_ssd.launches = 0
