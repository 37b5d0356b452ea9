"""Plain PyTorch versions of the ported kernels.

Each function computes what its Hopper kernel computes, with the reference
Pallas kernel's arithmetic: the same casts, the same places where float32
accumulation starts, the same mask fill and normaliser clamp.  The CPU
path of every kernel wrapper runs these; ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .common import pick_block

NEG_INF = -1e30


def act(kind: str, x: torch.Tensor) -> torch.Tensor:
    """silu, or gelu with the tanh approximation (``repro`` convention)."""
    if kind == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


def rms_rows(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMS-normalise rows with a ``(1 + scale)`` gain, rounded to the x
    dtype (``rmsnorm_matmul.py:29-33``, ``streamed_ffn.py:48-54``)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return y.to(x.dtype)


def rmsnorm_matmul(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """x [T, D], scale [D], w [D, N] -> rms_norm(x) @ w [T, N], x dtype.
    The normalised row is rounded to the x dtype before the product; the
    product accumulates in float32."""
    xn = rms_rows(x, scale, eps)
    return torch.matmul(xn.float(), w.float()).to(x.dtype)


def block_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ w [K, N] -> [M, N] in the x dtype, accumulated in float32
    (``block_matmul.py:29-39``)."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def streamed_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor, *, activation: str = "silu",
                 norm_scale: Optional[torch.Tensor] = None,
                 norm_eps: float = 1e-6) -> torch.Tensor:
    """x [T, D]; wg/wu [D, F]; wd [F, D] -> (act(xn@wg)*(xn@wu)) @ wd.
    ``xn`` is the folded RMSNorm rounded to the x dtype (or x itself); gate
    and up accumulate in float32; ``h`` is rounded to the x dtype before
    the down product (``streamed_ffn.py:70-74``)."""
    xn = rms_rows(x, norm_scale, norm_eps) if norm_scale is not None else x
    x32 = xn.float()
    h = act(activation, x32 @ wg.float()) * (x32 @ wu.float())
    return (h.to(x.dtype).float() @ wd.float()).to(x.dtype)


def streamed_mlp(x: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
                 activation: str = "gelu",
                 norm_scale: Optional[torch.Tensor] = None,
                 norm_eps: float = 1e-6) -> torch.Tensor:
    """x [T, D]; wu [D, F]; wd [F, D] -> act(xn @ wu) @ wd.  As
    ``_mlp_kernel`` (``streamed_ffn.py:181-202``): the up product
    accumulates in float32, ``h`` is rounded to the x dtype before the down
    product, which accumulates in float32."""
    xn = rms_rows(x, norm_scale, norm_eps) if norm_scale is not None else x
    h = act(activation, xn.float() @ wu.float())
    return (h.to(x.dtype).float() @ wd.float()).to(x.dtype)


def flash_attention_offset(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, q_offset: int, kv_len: int,
                           kv_group: int = 1, scale: Optional[float] = None,
                           causal: bool = True, window: int = 0,
                           block_kv: int = 128) -> torch.Tensor:
    """Chunk attention at absolute query positions ``q_offset + i``.

    q [Hq_, Sq, D]; k/v [Hkv_, Skv, D] with ``Hq_ == Hkv_ * kv_group``
    (query head b reads KV head ``b // kv_group``) -> [Hq_, Sq, D].
    Online softmax over KV blocks as ``_flash_kernel_offset``
    (``flash_attention.py:86-148``): QK products of the input dtype summed
    in float32, *then* scaled; ``p`` rounded to the v dtype before PV; the
    mask fills ``-1e30`` and the normaliser is clamped at ``1e-30``.
    """
    h, sq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk = k.repeat_interleave(kv_group, dim=0)
    vv = v.repeat_interleave(kv_group, dim=0)
    bkv = pick_block(skv, block_kv)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((h, sq, d), dtype=torch.float32, device=q.device)
    q32 = q.float()
    for k0 in range(0, min(skv, kv_len), bkv):
        kb = kk[:, k0:k0 + bkv].float()
        vb = vv[:, k0:k0 + bkv]
        s = torch.matmul(q32, kb.transpose(1, 2)) * scale
        k_pos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
        mask = k_pos < kv_len
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_static(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, kv_len: int,
                           kv_group: int = 1, scale: Optional[float] = None,
                           causal: bool = True, window: int = 0,
                           block_kv: int = 128) -> torch.Tensor:
    """Full-sequence attention with a static ``kv_len``: query i sits at
    position i.  ``_flash_kernel`` (``flash_attention.py:33-83``) is the
    offset kernel's arithmetic at ``q_offset = 0``; its causal block skip
    drops only blocks whose every score is masked, which leaves the online
    softmax unchanged."""
    return flash_attention_offset(q, k, v, q_offset=0, kv_len=kv_len,
                                  kv_group=kv_group, scale=scale,
                                  causal=causal, window=window,
                                  block_kv=block_kv)


def paged_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           q_off: torch.Tensor, *, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """W-row speculative-verify attention read through a page table.

    q [B, W, Hq, D]; pools [P, ps, Hkv, D]; page_table [B, maxp] int32;
    q_off [B] the position of window row 0 -> [B, W, Hq, D].  The eager
    ``verify_attention`` (``layers.py:447``) over the gathered pages: row
    i sees the first ``q_off + i + 1`` positions, intersected with the
    sliding window; with the Pallas kernels' arithmetic
    (``paged_attention.py:169-229``): ``q * scale`` in float32 first, K/V
    in float32, masked scores at -1e30, float32 PV, the normaliser
    clamped at 1e-30, so a row of length 0 gives zeros.
    """
    b, w, hq, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    maxp = page_table.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, w, hkv, g, d).float() * scale
    tbl = page_table.long()
    # [B, 1, Hkv, S, D]: the window rows are a batch dimension of both
    # products, so each row's sums are the ones the W = 1 call takes.
    k = k_pool[tbl].reshape(b, maxp * ps, hkv, d).float() \
        .permute(0, 2, 1, 3)[:, None]
    v = v_pool[tbl].reshape(b, maxp * ps, hkv, d).float() \
        .permute(0, 2, 1, 3)[:, None]
    s = torch.matmul(qg, k.transpose(-1, -2))           # [B, W, Hkv, G, S]
    pos = torch.arange(maxp * ps, device=q.device)
    qlen = (q_off.to(q.device).long()[:, None]
            + torch.arange(w, device=q.device)[None] + 1)       # [B, W]
    valid = pos[None, None] < qlen[..., None]                   # [B, W, S]
    if window:
        valid = valid & (pos[None, None] >= qlen[..., None] - window)
    valid = valid[:, :, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v) / torch.clamp(l, min=1e-30)  # [B, W, Hkv, G, D]
    return out.reshape(b, w, hq, d).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, *, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One-token GQA attention read through a page table: the verify
    window at W = 1 with row 0 at ``lengths - 1``.

    q [B, 1, Hq, D]; pools [P, ps, Hkv, D]; page_table [B, maxp] int32;
    lengths [B] -> [B, 1, Hq, D].  As ``_paged_decode_kernel``
    (``paged_attention.py:61-110``); a slot of length 0 gives zeros.
    """
    return paged_verify_attention(q, k_pool, v_pool, page_table,
                                  lengths.to(q.device).long() - 1,
                                  window=window, scale=scale)
