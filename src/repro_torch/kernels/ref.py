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
FP8 = torch.float8_e4m3fn


def code_view(t: torch.Tensor) -> torch.Tensor:
    """A tensor of fp8 codes as raw bytes (``uint8``), anything else as it
    is: indexing and index-put on ``float8_e4m3fn`` need not exist on every
    device, so code pools are gathered and scattered through their bytes
    (``.view(t.dtype)`` turns the result back)."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


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


def rmsnorm_matmul_w8(x: torch.Tensor, scale: torch.Tensor,
                      w: torch.Tensor, w_scale: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Weight-only int8 twin (``rmsnorm_matmul.py:38-50``): w [D, N] int8
    codes, w_scale [N] float32.  The normalised row stays float32 (not
    rounded to the x dtype); the column scale multiplies the float32 sum
    after the K reduction."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    acc = torch.matmul(normed, w.float())
    return (acc * w_scale.float()[None, :]).to(x.dtype)


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x [T, D] -> ((x - mean) * rsqrt(var + eps) * scale + bias) in the x
    dtype, statistics in float32 (the eager ``layer_norm``,
    ``layers.py:195``)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def moe_experts(x: torch.Tensor, gates: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor, wd: torch.Tensor,
                activation: str = "silu") -> torch.Tensor:
    """Dense-gather MoE experts (``moe_experts.py:35``): x [T, D], gates
    [T, E] (zero off the top-k), wg/wu [E, D, F], wd [E, F, D] -> [T, D]
    in the x dtype.  For each expert in order: ``h = act(x @ wg[e]) *
    (x @ wu[e])`` summed in float32 and rounded to the x dtype, then ``h @
    wd[e]`` in float32 scaled by the expert's gate column and added to a
    float32 accumulator; experts with a zero gate are computed too."""
    x32 = x.float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(wg.shape[0]):
        h = (act(activation, x32 @ wg[e].float())
             * (x32 @ wu[e].float())).to(x.dtype)
        acc = acc + (h.float() @ wd[e].float()) * gates[:, e:e + 1].float()
    return acc.to(x.dtype)


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


def streamed_ffn_w8(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor, *, wg_scale: torch.Tensor,
                    wu_scale: torch.Tensor, wd_scale: torch.Tensor,
                    activation: str = "silu",
                    norm_scale: Optional[torch.Tensor] = None,
                    norm_eps: float = 1e-6) -> torch.Tensor:
    """Weight-only int8 twin (``_ffn_kernel_w8``, ``streamed_ffn.py:81``):
    wg/wu/wd int8 codes with float32 per-output-channel scales.  ``xn`` is
    rounded to the x dtype as in the full-precision body; the gate and up
    scales apply before the activation; ``h`` stays float32; the down
    scale applies after the down product."""
    xn = rms_rows(x, norm_scale, norm_eps) if norm_scale is not None else x
    x32 = xn.float()
    gate = (x32 @ wg.float()) * wg_scale.float()[None]
    up = (x32 @ wu.float()) * wu_scale.float()[None]
    h = act(activation, gate) * up
    return ((h @ wd.float()) * wd_scale.float()[None]).to(x.dtype)


def streamed_mlp_w8(x: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, *,
                    wu_scale: torch.Tensor, wd_scale: torch.Tensor,
                    activation: str = "gelu",
                    norm_scale: Optional[torch.Tensor] = None,
                    norm_eps: float = 1e-6) -> torch.Tensor:
    """Weight-only int8 ungated twin (``_mlp_kernel_w8``,
    ``streamed_ffn.py:205``), as ``streamed_ffn_w8``."""
    xn = rms_rows(x, norm_scale, norm_eps) if norm_scale is not None else x
    up = (xn.float() @ wu.float()) * wu_scale.float()[None]
    h = act(activation, up)
    return ((h @ wd.float()) * wd_scale.float()[None]).to(x.dtype)


def flash_attention_offset(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, q_offset: int, kv_len: int,
                           kv_group: int = 1, scale: Optional[float] = None,
                           causal: bool = True, window: int = 0,
                           block_kv: int = 128,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Chunk attention at absolute query positions ``q_offset + i``.

    q [Hq_, Sq, D]; k/v [Hkv_, Skv, D] with ``Hq_ == Hkv_ * kv_group``
    (query head b reads KV head ``b // kv_group``) -> [Hq_, Sq, D].
    Online softmax over KV blocks as ``_flash_kernel_offset``
    (``flash_attention.py:86-148``): QK products of the input dtype summed
    in float32, *then* scaled; ``p`` rounded to the v dtype before PV; the
    mask fills ``-1e30`` and the normaliser is clamped at ``1e-30``.

    Quantized K/V (``_flash_kernel_offset_q``, ``flash_attention.py:151``):
    k/v hold int8 or fp8 codes and ``k_scale``/``v_scale`` [Hkv_, Skv]
    float32 per-position scales; each block is dequantized
    (``code * scale``) before its product, and ``p`` stays float32.
    """
    h, sq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk = k.float().repeat_interleave(kv_group, dim=0)
    vv = v.float().repeat_interleave(kv_group, dim=0)
    quant = k_scale is not None
    if quant:
        kk = kk * k_scale.float().repeat_interleave(kv_group, dim=0)[..., None]
        vv = vv * v_scale.float().repeat_interleave(kv_group, dim=0)[..., None]
    bkv = pick_block(skv, block_kv)
    q_pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    m = torch.full((h, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((h, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((h, sq, d), dtype=torch.float32, device=q.device)
    q32 = q.float()
    for k0 in range(0, min(skv, kv_len), bkv):
        kb = kk[:, k0:k0 + bkv]
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
        pv = p if quant else p.to(v.dtype).float()
        acc = acc * corr + torch.matmul(pv, vb)
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
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """W-row speculative-verify attention read through a page table.

    q [B, W, Hq, D]; pools [P, ps, Hkv, D]; page_table [B, maxp] int32;
    q_off [B] the position of window row 0 -> [B, W, Hq, D].  The eager
    ``verify_attention`` (``layers.py:447``) over the gathered pages: row
    i sees the first ``q_off + i + 1`` positions, intersected with the
    sliding window; with the Pallas kernels' arithmetic
    (``paged_attention.py:169-229``): ``q * scale`` in float32 first, K/V
    in float32, masked scores at -1e30, float32 PV, the normaliser
    clamped at 1e-30, so a row of length 0 gives zeros.

    Quantized pools (``_paged_verify_kernel_q``, ``paged_attention.py:232``):
    int8 or fp8 codes and ``k_scale``/``v_scale`` [P, Hkv] float32, each
    page dequantized (``code * scale[page, head]``) before the products.
    """
    b, w, hq, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    maxp = page_table.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, w, hkv, g, d).float() * scale
    tbl = page_table.long()

    def gather(pool, pool_scale):
        pages = code_view(pool)[tbl].view(pool.dtype).float()
        if pool_scale is not None:                  # [B, maxp, ps, Hkv, D]
            pages = pages * pool_scale.float()[tbl][:, :, None, :, None]
        # [B, 1, Hkv, S, D]: the window rows are a batch dimension of both
        # products, so each row's sums are the ones the W = 1 call takes.
        return pages.reshape(b, maxp * ps, hkv, d).permute(0, 2, 1, 3)[:, None]

    k = gather(k_pool, k_scale)
    v = gather(v_pool, v_scale)
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
                           scale: Optional[float] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One-token GQA attention read through a page table: the verify
    window at W = 1 with row 0 at ``lengths - 1``.

    q [B, 1, Hq, D]; pools [P, ps, Hkv, D]; page_table [B, maxp] int32;
    lengths [B] -> [B, 1, Hq, D].  As ``_paged_decode_kernel``
    (``paged_attention.py:61-110``; quantized pools as
    ``_paged_decode_kernel_q``, :113); a slot of length 0 gives zeros.
    """
    return paged_verify_attention(q, k_pool, v_pool, page_table,
                                  lengths.to(q.device).long() - 1,
                                  window=window, scale=scale,
                                  k_scale=k_scale, v_scale=v_scale)


def xent_parts_ref(hidden: torch.Tensor, head: torch.Tensor,
                   labels: torch.Tensor, vocab_size: int):
    """hidden [T, D], head [D, Vp], labels [T] in [0, Vp) -> (lse [T],
    gold [T]) float32 (``ref.py:73``): logits from the float32 upcast
    operands, pad-vocab columns (``v >= vocab_size``) at -1e30, ``lse`` by
    logsumexp and ``gold`` the label's (masked) logit."""
    logits = torch.matmul(hidden.float(), head.float())
    pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
    logits = logits.masked_fill(pad, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return lse, gold


def xent_nll_mean(lse: torch.Tensor, gold: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Mean of ``lse - gold`` over ``labels >= 0`` (the reference's
    ``streamed_xent_loss`` tail): 0 for a batch with no valid label."""
    valid = labels >= 0
    nll = torch.where(valid, lse - gold, 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def xent_loss_ref(hidden: torch.Tensor, head: torch.Tensor,
                  labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mean cross-entropy over ``labels >= 0`` (``ref.py:82``); ignored
    labels (-100) are clamped to 0 before the gather."""
    lse, gold = xent_parts_ref(hidden, head, torch.clamp(labels, min=0),
                               vocab_size)
    return xent_nll_mean(lse, gold, labels)
