"""The RWKV6 wkv recurrence (the plan's ``mixer`` on an RWKV6 stack, K14).

``wkv6`` launches ``csrc/rwkv6_wkv.cu`` on CUDA tensors and runs
``ref.wkv6`` on CPU tensors; ``wkv6.launches`` counts calls that launch
(one per call, however many launches the call makes).  r, k and v are in
the compute dtype (bfloat16 or float32, the entry point is keyed on r's),
w is float32 whatever the compute dtype; u goes to the bf16 kernels as it
is (bf16 or float32) and is cast to float32 for the float32 kernel.  Both
dtypes take head sizes 16, 32, 64 and 128 and any S; ``chunk`` is the
reference's grid cut, checked to divide S and not used by either kernel.

- float32: a block owns 16 state columns of one head and walks every
  token in order on the CUDA cores.
- bf16: the sequence-split scan on the tensor cores, in segments of
  ``wkv_plan(S)`` tokens counted from position 0: each segment's own end
  state and decay, a pass across segments, then the outputs in sub-blocks
  of 16 tokens; three launches (one when S fits in one segment) through a
  float32 workspace allocated per call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, ref
from .common import (aligned16, check_cuda_operands, check_launch,
                     kernel_path, wkv_plan)

# Head sizes the CUDA kernels are built for.
HEAD_SIZES = (16, 32, 64, 128)


def cuda_refusal(n: int) -> Optional[str]:
    """Why the CUDA build refuses head size ``n``, or None."""
    if n in HEAD_SIZES:
        return None
    return f"head size {n}; the CUDA kernel runs {HEAD_SIZES}"


def smem_bytes(n: int, dtype: torch.dtype) -> dict:
    """{kernel: shared memory per block} of a call at head size ``n``.
    float32 (static): 2048 / N tokens of r, k and w staged per pass, and
    their 16 state columns of v.  bf16 (dynamic, ``walk_smem``): a
    three-slot ring of 16-token sub-blocks (r for the outputs, k, v at a
    row stride of N + 8, w in float32), the hi + lo planes of k o P (and
    r o P) and, for the outputs, of the scores, then u and the decay; the
    carry across segments takes none."""
    if dtype != torch.bfloat16:
        tt = 2048 // n
        return {f"wkv6_kernel<float, {n}>": 4 * (3 * tt * n + tt * 16)}
    sub, ring, ldv, la = 16, 3, n + 8, 16 + 8

    def walk(out: bool) -> int:
        slot = ((sub * n * 2 if out else 0) + sub * n * 2 + sub * ldv * 2
                + sub * n * 4)
        return (ring * slot + (4 if out else 2) * sub * ldv * 2
                + (2 * sub * la * 2 if out else 0) + 2 * n * 4)
    return {f"wkv_seg_state_kernel<{n}>": walk(False),
            f"wkv_seg_out_kernel<{n}>": walk(True),
            f"wkv_seg_carry_kernel<{n}>": 0}


def workspace_numel(bsz: int, h: int, n: int, nseg: int) -> int:
    """float32 values of the bf16 scan's workspace: each segment's state
    [B, H, nseg, N, N] (values x keys), then its decay [B, H, nseg, N]."""
    return bsz * h * nseg * (n * n + n)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("rwkv6_wkv")
    vp, i = ctypes.c_void_p, ctypes.c_int
    if dtype == torch.bfloat16:
        return _build.declare(lib, "repro_wkv6_seg_bf16",
                              [vp] * 5 + [i] + [vp] * 3 + [i] * 6 + [vp])
    return _build.declare(lib, "repro_wkv6_f32", [vp] * 7 + [i] * 4 + [vp])


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64):
    """r/k/v/w [B, S, H, N], u [H, N] -> (y [B, S, H, N] in r's dtype, the
    final state [B, H, N, N] float32), the state starting at zero.
    ``min(chunk, S)`` must divide S, as in the reference wrapper."""
    bsz, s, h, n = r.shape
    q = min(chunk, s)
    if (any(tuple(t.shape) != (bsz, s, h, n) for t in (k, v, w))
            or tuple(u.shape) != (h, n) or q < 1 or s % q):
        raise ValueError(f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u "
                         f"{tuple(u.shape)}, chunk {chunk}")
    if kernel_path(r) == "plain":
        return ref.wkv6(r, k, v, w, u)
    bf16 = r.dtype == torch.bfloat16
    # The bf16 kernels read u as it is, bf16 or float32 (no launch of its
    # own); the float32 kernel takes float32.
    uk = (u if bf16 and u.dtype in (torch.float32, torch.bfloat16)
          else u.float()).contiguous()
    check_cuda_operands("wkv6", r.dtype, r, k, v, w, uk)
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6: r, k and v must share a dtype (got "
                        f"{r.dtype}, {k.dtype}, {v.dtype})")
    if w.dtype != torch.float32:
        raise TypeError(f"wkv6: the decay w must be float32, got {w.dtype}")
    why = cuda_refusal(n)
    if why is not None:
        raise ValueError(f"wkv6: {why}")
    y = torch.empty_like(r)
    state = torch.empty((bsz, h, n, n), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    if bf16:
        seg, nseg = wkv_plan(s)
        r, k, v, w = (aligned16(t) for t in (r, k, v, w))
        ws = torch.empty(workspace_numel(bsz, h, n, nseg),
                         dtype=torch.float32, device=r.device)
        status = _entry(r.dtype)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uk.data_ptr(), int(uk.dtype == torch.bfloat16), y.data_ptr(),
            state.data_ptr(), ws.data_ptr(), bsz, s, h, n, seg, nseg,
            stream)
    else:
        status = _entry(r.dtype)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uk.data_ptr(), y.data_ptr(), state.data_ptr(), bsz, s, h, n,
            stream)
    check_launch("wkv6", status)
    wkv6.launches += 1
    return y, state


wkv6.launches = 0
