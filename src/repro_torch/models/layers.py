"""Model layers in PyTorch (functions over parameter dicts).

The eager functions mirror ``repro.models.layers`` — the reference's own
``use_fused_kernels=False`` path — cast for cast: norms and softmax in
float32, matmuls in the compute dtype, attention scores accumulated in
float32.  The ``fused_*`` wrappers reshape model-layout tensors for the
kernels the StreamPlan selected (single device; the sharded dispatch comes
with the distributed slice).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from .. import kernels as K
from ..kernels.ref import NEG_INF, act

Params = Dict[str, Any]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Raw ``y * scale + bias`` (not ``1 + scale``), population variance
    (``layers.py:195``)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(kind: str, x: torch.Tensor, p: Params) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, S, H, D]; positions [B, S] -> rotate-half RoPE, float32 angles."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs               # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def apply_positional(kind: str, x: torch.Tensor, positions: torch.Tensor,
                     theta: float) -> torch.Tensor:
    if kind == "rope":
        return apply_rope(x, positions, theta)
    if kind == "none":               # learned positions, added at the embed
        return x
    raise NotImplementedError(f"positional encoding {kind!r} is not ported")


def streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        window: int = 0, chunk_size: int = 1024,
                        kv_len: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Chunked online-softmax attention (``layers.py:313``).

    q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D]; query i at position
    ``q_offset + i``; keys at or past ``kv_len`` masked -> [B, Sq, Hq, D].
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    kv_len = skv if kv_len is None else kv_len
    g = hq // hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = (q * sc).reshape(b, sq, hkv, g, d).float()
    c = min(chunk_size, skv)
    if skv % c:
        pad = c - skv % c
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nc = k.shape[1] // c
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for ci in range(nc):
        kb = k[:, ci * c:(ci + 1) * c]
        vb = v[:, ci * c:(ci + 1) * c]
        kv_pos = ci * c + torch.arange(c, device=q.device)
        s = torch.einsum("bqhgd,bchd->bhgqc", qg, kb.float())
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        else:
            mask = torch.ones((sq, c), dtype=torch.bool, device=q.device)
        mask = mask & (kv_pos[None, :] < kv_len)
        if window:
            mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqc,bchd->bhgqd", p.to(vb.dtype).float(),
                          vb.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """One-token attention against a dense ("bshd") cache (``:403``):
    q [B, 1, Hq, D]; caches [B, S, Hkv, D]; cache_len [B].  PV in float32."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = (q * (1.0 / math.sqrt(d))).reshape(b, 1, hkv, g, d)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k_cache.float())
    pos = torch.arange(s, device=q.device)
    lens = cache_len.reshape(-1, 1).long()
    valid = pos[None] < lens
    if window:
        valid = valid & (pos[None] >= lens - window)
    scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, q_off: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """W-token speculative-verify attention against a dense ("bshd")
    cache (``layers.py:447``): q [B, W, Hq, D]; caches [B, S, Hkv, D];
    q_off [B] the position of window row 0, so row i attends to the first
    ``q_off + i + 1`` positions.  The W-row twin of ``decode_attention``:
    scores, softmax and PV in float32, so row i computes what
    ``decode_attention`` computes at length ``q_off + i + 1``."""
    b, w, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = (q * (1.0 / math.sqrt(d))).reshape(b, w, hkv, g, d)
    scores = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k_cache.float())
    pos = torch.arange(s, device=q.device)
    qlen = (q_off.reshape(-1, 1).long()
            + torch.arange(w, device=q.device)[None] + 1)       # [B, W]
    valid = pos[None, None] < qlen[..., None]                   # [B, W, S]
    if window:
        valid = valid & (pos[None, None] >= qlen[..., None] - window)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqs,bshd->bqhgd", p, v_cache.float())
    return out.reshape(b, w, hq, d).to(q.dtype)


def ffn(x: torch.Tensor, p: Params, *, activation: str,
        gated: bool) -> torch.Tensor:
    if gated:
        return (act(activation, x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    return act(activation, x @ p["wu"]) @ p["wd"]


# --------------------------------------------------------------------- #
# Fused wrappers (the plan's kernels)
# --------------------------------------------------------------------- #

def fused_norm_matmul(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                      *, eps: float = 1e-6) -> torch.Tensor:
    """rms_norm(x) @ w through ``rmsnorm_matmul``: x [B, S, D] -> [B, S, N]."""
    b, s, d = x.shape
    y = K.rmsnorm_matmul(x.reshape(b * s, d).contiguous(), scale, w, eps=eps)
    return y.reshape(b, s, w.shape[-1])


def fused_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w through ``block_matmul``: x [B, S, D] -> [B, S, N]."""
    b, s, d = x.shape
    y = K.block_matmul(x.reshape(b * s, d).contiguous(), w)
    return y.reshape(b, s, w.shape[-1])


def fused_ffn(x: torch.Tensor, p: Params, *, activation: str, gated: bool,
              norm_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GLU FFN through ``streamed_ffn``, or the ungated MLP through
    ``streamed_mlp``; with ``norm_scale`` the pre-FFN RMSNorm is folded
    into the kernel."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d).contiguous()
    if gated:
        y = K.streamed_ffn(xf, p["wg"], p["wu"], p["wd"],
                           activation=activation, norm_scale=norm_scale)
    else:
        y = K.streamed_mlp(xf, p["wu"], p["wd"], activation=activation,
                           norm_scale=norm_scale)
    return y.reshape(b, s, d)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_kv: int = 512) -> torch.Tensor:
    """Whole-sequence attention through the static flash kernel."""
    return K.flash_attention(q, k, v, causal=causal, window=window,
                             block_kv=block_kv)


def fused_attention_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_offset: int, kv_len: int, *, causal: bool = True,
                          window: int = 0,
                          block_kv: int = 512) -> torch.Tensor:
    """Chunked-prefill attention through the offset flash kernel."""
    return K.flash_attention(q, k, v, q_offset=q_offset, kv_len=kv_len,
                             causal=causal, window=window, block_kv=block_kv)


def fused_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, *,
                          window: int = 0) -> torch.Tensor:
    """Decode attention through the paged kernel (pools read in place)."""
    return K.paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                    page_table, lengths, window=window)


def fused_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           q_off: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """Speculative-verify attention through the paged verify kernel: one
    launch scores every window row of every slot (``layers.py:1034``,
    single device)."""
    return K.paged_verify_attention(q.contiguous(), k_pool, v_pool,
                                    page_table, q_off, window=window)
