"""The RWKV6 wkv recurrence (the plan's ``mixer`` on an RWKV6 stack, K14).

``wkv6`` launches ``csrc/rwkv6_wkv.cu`` on CUDA tensors and runs
``ref.wkv6`` on CPU tensors; ``wkv6.launches`` counts kernel launches.
r, k and v are in the compute dtype (bfloat16 or float32, the entry point
is keyed on r's), w is float32 whatever the compute dtype, u is cast to
float32 here.  The CUDA kernel takes head sizes 16, 32, 64 and 128 and
any S; ``chunk`` is the reference's grid cut, checked to divide S and not
used by the kernel, whose result and speed do not depend on it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref
from .common import check_cuda_operands, check_launch, kernel_path

# Head sizes the CUDA kernel is built for.
HEAD_SIZES = (16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    lib = _build.load("rwkv6_wkv")
    sym = "repro_wkv6_bf16" if dtype == torch.bfloat16 else "repro_wkv6_f32"
    vp, i = ctypes.c_void_p, ctypes.c_int
    return _build.declare(lib, sym, [vp] * 7 + [i] * 4 + [vp])


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
    u32 = u.float().contiguous()
    check_cuda_operands("wkv6", r.dtype, r, k, v, w, u32)
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6: r, k and v must share a dtype (got "
                        f"{r.dtype}, {k.dtype}, {v.dtype})")
    if w.dtype != torch.float32:
        raise TypeError(f"wkv6: the decay w must be float32, got {w.dtype}")
    if n not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {n}; the CUDA kernel runs "
                         f"{HEAD_SIZES}")
    y = torch.empty_like(r)
    state = torch.empty((bsz, h, n, n), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    status = _entry(r.dtype)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u32.data_ptr(), y.data_ptr(), state.data_ptr(), bsz, s, h, n,
        stream)
    check_launch("wkv6", status)
    wkv6.launches += 1
    return y, state


wkv6.launches = 0
