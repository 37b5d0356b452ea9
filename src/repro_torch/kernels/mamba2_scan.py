"""The Mamba2 chunked SSD scan (the plan's ``mixer``, K13).

``mamba2_ssd`` launches ``csrc/mamba2_scan.cu`` on a CUDA tensor and runs
``ref.mamba2_ssd`` on a CPU tensor; ``mamba2_ssd.launches`` counts calls
that launch (one per call, however many launches the call makes).  Both
dtypes read B and C, one group shared by every head, in place.

- float32: one block per (batch, head) walks the caller's chunks of Q
  rows in order (any Q that divides S; the model asks for the largest
  divisor of S up to 128).
- bf16: the sequence-split scan on the tensor cores, in segments of
  ``ssd_plan(S)`` rows counted from position 0 whatever the caller's Q
  (which must still divide S, as the reference asserts): three launches
  through a float32 workspace of each segment's state, allocated per
  call.  It takes zamba2's P = N = 64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref
from .common import (MAX_SMEM, aligned16, check_cuda_operands,
                     check_launch, kernel_path, ssd_plan)

# (P, N) of the bf16 kernels (zamba2's head dim and state).
SEG_PN = (64, 64)


def smem_bytes(q: int, p: int, n: int,
               dtype: torch.dtype = torch.float32) -> dict:
    """{kernel: shared memory per block} of a call in chunks of ``q`` rows.
    float32 (dynamic, csrc/mamba2_scan.cu): the chunk's x [Q, P], B and C
    [Q, N + 1], the masked (C B^T) o L [Q, Q], the state [P, N + 1] and
    three [Q] vectors, all float32.  bf16 (static, whatever Q): a
    64-row segment's x, B and B' hi / lo (or B, C and the carried state's
    hi / lo planes) at a row stride of 72 bf16, and its per-row scalars;
    the carry across segments takes none."""
    if dtype != torch.bfloat16:
        return {"mamba2_ssd_kernel<float>":
                4 * (q * p + 2 * q * (n + 1) + q * q + p * (n + 1) + 3 * q)}
    seg = 64
    lx, lb = p + 8, n + 8
    return {f"ssd_seg_state_kernel<{p}, {n}>":
            2 * (seg * lx + 2 * seg * lb) + 4 * 3 * seg,
            f"ssd_seg_out_kernel<{p}, {n}>":
            2 * (seg * lx + 2 * seg * lb + 2 * p * lb) + 4 * 2 * seg,
            f"ssd_seg_carry_kernel<{p * n}>": 0}


def case_refusal(p: int, n: int, dtype: torch.dtype) -> Optional[str]:
    """Why the CUDA build has no kernel for (P, N) in ``dtype``, or None:
    the bf16 kernels take (P, N) = ``SEG_PN``."""
    if dtype == torch.bfloat16 and (p, n) != SEG_PN:
        return f"the bf16 kernel takes (P, N) = {SEG_PN}; got ({p}, {n})"
    return None


def cuda_refusal(q: int, p: int, n: int, dtype: torch.dtype
                 ) -> Optional[str]:
    """Why the CUDA build refuses a call, or None: ``case_refusal``, or a
    float32 block of ``q``-row chunks past ``MAX_SMEM``."""
    why = case_refusal(p, n, dtype)
    if why is not None or dtype == torch.bfloat16:
        return why
    need = max(smem_bytes(q, p, n).values())
    if need > MAX_SMEM:
        return (f"chunk {q} with P {p}, N {n} needs {need} bytes of shared "
                "memory")
    return None


def workspace_numel(bsz: int, h: int, p: int, n: int, nseg: int) -> int:
    """float32 values of the bf16 scan's workspace: each segment's end
    state [B, H, nseg, P, N], then its decay [B, H, nseg]."""
    return bsz * h * nseg * (p * n + 1)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("mamba2_scan")
    vp, i = ctypes.c_void_p, ctypes.c_int
    if dtype == torch.bfloat16:
        return _build.declare(lib, "repro_mamba2_ssd_seg_bf16",
                              [vp] * 6 + [i] + [vp] * 3 + [i] * 7 + [vp])
    return _build.declare(lib, "repro_mamba2_ssd_f32",
                          [vp] * 8 + [i] * 6 + [vp])


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor, d_skip: torch.Tensor, *,
               chunk: int = 128):
    """x [B, S, H, P]; dt [B, S, H]; a_log [H]; b/c [B, S, N]; d_skip [H]
    -> (y [B, S, H, P] in x's dtype, final state [B, H, P, N] float32),
    in chunks of ``min(chunk, S)`` rows, which must divide S (the bf16
    kernel's segments do not depend on it)."""
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
    bf16 = x.dtype == torch.bfloat16
    why = cuda_refusal(q, p, n, x.dtype)
    if why is not None:
        raise ValueError(f"mamba2_ssd: {why}")
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if bf16:
        # The kernels take a = -exp(a_log) and d_skip from the parameters
        # as they are (bf16 or float32), with no launch of their own.
        if (a_log.dtype not in (torch.float32, torch.bfloat16)
                or d_skip.dtype != a_log.dtype):
            a_log, d_skip = a_log.float(), d_skip.float()
        seg, nseg = ssd_plan(s)
        x, b, c = aligned16(x), aligned16(b), aligned16(c)
        ws = torch.empty(workspace_numel(bsz, h, p, n, nseg),
                         dtype=torch.float32, device=x.device)
        status = _entry(x.dtype)(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), d_skip.data_ptr(),
            int(a_log.dtype == torch.bfloat16), y.data_ptr(),
            state.data_ptr(), ws.data_ptr(), bsz, s, h, p, n, seg, nseg,
            stream)
    else:
        # The per-head constants, as the reference wrapper prepares them.
        a = -torch.exp(a_log.float())
        d = d_skip.float()
        status = _entry(x.dtype)(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), d.data_ptr(), y.data_ptr(), state.data_ptr(), bsz,
            s, h, p, n, q, stream)
    check_launch("mamba2_ssd", status)
    mamba2_ssd.launches += 1
    return y, state


mamba2_ssd.launches = 0
