"""Model layers in PyTorch (functions over parameter dicts).

The eager functions mirror ``repro.models.layers`` — the reference's own
``use_fused_kernels=False`` path — cast for cast: norms and softmax in
float32, matmuls in the compute dtype, attention scores accumulated in
float32.  The ``fused_*`` wrappers reshape model-layout tensors for the
kernels the StreamPlan selected (single device; the sharded dispatch comes
with the distributed slice).

Gradients (``_kernel_fwd_eager_bwd``, the reference's
``_pallas_fwd_eager_bwd``): where an input requires grad and grad mode is
on, a wrapper runs its kernel for the forward value and recomputes the
backward through the eager formulation it replaces, from the saved
inputs; there is no backward kernel, as the reference has none.  Serving
runs under ``torch.no_grad()`` and calls the kernel directly, with no
autograd node.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from .. import kernels as K
from ..kernels.ref import NEG_INF, act, xent_nll_mean

Params = Dict[str, Any]
# A weight on a w8 stage: the tensor itself (quantized at each call, as the
# reference does) or its cached (int8 codes, float32 scales) pair
# (``params.quantize_weights``).
W8Weight = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


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


# --------------------------------------------------------------------- #
# Weight-only int8 (DESIGN.md §14)
# --------------------------------------------------------------------- #

def quantize_channelwise(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 (``layers.py:216``): w [D, N] ->
    (codes int8, scales [N] float32 = amax|column| / 127).  An all-zero
    column encodes to zero codes with scale 0."""
    w32 = w.float()
    scales = w32.abs().amax(dim=0) / 127.0
    safe = torch.where(scales > 0.0, scales, 1.0)
    codes = torch.clamp(torch.round(w32 / safe), -127.0, 127.0)
    return codes.to(torch.int8), scales


def dequantize_channelwise(codes: torch.Tensor, scales: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
    return (codes.float() * scales[None, :]).to(dtype)


def w8_codes(w: W8Weight) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, scales) of a w8 stage's weight, cached or quantized now."""
    return w if isinstance(w, tuple) else quantize_channelwise(w)


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


def gates_from_logits(logits: torch.Tensor, top_k: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """Renormalised top-k gate weights [..., E] from router logits
    (``layers.py:509-517``): softmax in float32, the k-th largest
    probability as the threshold, every expert at or above it kept (ties
    keep more than k), renormalised with a 1e-9 floor, cast to ``dtype``.
    ``topk`` gives only the threshold value, never indices."""
    probs = torch.softmax(logits.float(), dim=-1)
    thresh = torch.topk(probs, top_k, dim=-1).values[..., -1:]
    gates = torch.where(probs >= thresh, probs, 0.0)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return gates.to(dtype)


def moe_gates(x: torch.Tensor, wr: torch.Tensor,
              top_k: int) -> torch.Tensor:
    """Router: ``x @ wr`` in x's dtype, then ``gates_from_logits``
    (``layers.py:509``)."""
    return gates_from_logits(x @ wr, top_k, x.dtype)


def moe_experts_eager(x: torch.Tensor, gates: torch.Tensor,
                      wg: Optional[torch.Tensor], wu: torch.Tensor,
                      wd: torch.Tensor, *, activation: str) -> torch.Tensor:
    """Every expert on every token, gate-weighted and summed (the
    dense-gather formulation, ``layers.py:533-541``): x [..., D], gates
    [..., E], wg/wu [E, D, F] (wg None: ungated), wd [E, F, D]."""
    up = torch.einsum("...d,edf->...ef", x, wu)
    h = (act(activation, torch.einsum("...d,edf->...ef", x, wg)) * up
         if wg is not None else act(activation, up))
    y = torch.einsum("...ef,efd->...ed", h, wd)
    return torch.einsum("...ed,...e->...d", y, gates)


def moe_ffn(x: torch.Tensor, p: Params, *, activation: str, gated: bool,
            top_k: int) -> torch.Tensor:
    """Dense-gather MoE (``layers.py:520``): the router's gates, then
    ``moe_experts_eager``."""
    return moe_experts_eager(x, moe_gates(x, p["wr"], top_k),
                             p["wg"] if gated else None, p["wu"], p["wd"],
                             activation=activation)


# --------------------------------------------------------------------- #
# Kernel forward, eager backward (``layers.py:697-716``)
# --------------------------------------------------------------------- #

class _KernelFwdEagerBwd(torch.autograd.Function):
    """The kernel computes the forward value (grad mode is off inside);
    the backward reruns ``eager`` on detached copies of the saved inputs
    with grad on and returns ``torch.autograd.grad`` of it.  Inputs that
    need no gradient (integer labels, frozen tensors) get None."""

    @staticmethod
    def forward(ctx, fused: Callable, eager: Callable, *args):
        ctx.eager = eager
        ctx.save_for_backward(*args)
        return fused(*args)

    @staticmethod
    def backward(ctx, *grads):
        wants = ctx.needs_input_grad[2:]
        inputs = [a.detach().requires_grad_(w)
                  for a, w in zip(ctx.saved_tensors, wants)]
        with torch.enable_grad():
            out = ctx.eager(*inputs)
        diff = [a for a, w in zip(inputs, wants) if w]
        got = iter(torch.autograd.grad(out, diff, grads, allow_unused=True)
                   if diff else ())
        return (None, None) + tuple(next(got) if w else None for w in wants)


def _kernel_fwd_eager_bwd(fused: Callable, eager: Callable) -> Callable:
    """``fused`` with ``eager``'s gradient.  Without grad mode, or when no
    input requires grad (serving), ``fused`` runs as it is."""
    def apply(*args):
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            return _KernelFwdEagerBwd.apply(fused, eager, *args)
        return fused(*args)
    return apply


def _refuse_w8_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "weight-only int8 stages have no gradient yet: the reference's "
            "straight-through _w8_ste (layers.py:233) comes with quantized "
            "training")


# --------------------------------------------------------------------- #
# Fused wrappers (the plan's kernels)
# --------------------------------------------------------------------- #

def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, S, D] -> [B * S, D], contiguous, for the token-major kernels."""
    return x.reshape(-1, x.shape[-1]).contiguous()


def fused_norm_matmul(x: torch.Tensor, scale: torch.Tensor, w: W8Weight,
                      *, eps: float = 1e-6, w8: int = 0) -> torch.Tensor:
    """rms_norm(x) @ w through ``rmsnorm_matmul``: x [B, S, D] -> [B, S, N]
    (``layers.py:725``).  ``w8`` (the plan's block flag): weight-only int8
    through the ``rmsnorm_matmul_w8`` twin (serving only)."""
    b, s, _ = x.shape
    if w8:
        _refuse_w8_grad(x, scale, w)
        codes, ws = w8_codes(w)
        y = K.rmsnorm_matmul_w8(_rows(x), scale, codes, w_scale=ws, eps=eps)
        return y.reshape(b, s, y.shape[-1])

    def fused(x, scale, w):
        return K.rmsnorm_matmul(_rows(x), scale, w, eps=eps).reshape(
            b, s, w.shape[-1])

    def eager(x, scale, w):
        return rms_norm(x, scale, eps) @ w

    return _kernel_fwd_eager_bwd(fused, eager)(x, scale, w)


def fused_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w through ``block_matmul``: x [B, S, D] -> [B, S, N]
    (``layers.py:772``)."""
    b, s, _ = x.shape

    def fused(x, w):
        return K.block_matmul(_rows(x), w).reshape(b, s, w.shape[-1])

    return _kernel_fwd_eager_bwd(fused, lambda x, w: x @ w)(x, w)


def fused_norm(kind: str, x: torch.Tensor, p: Params) -> torch.Tensor:
    """``apply_norm`` on the kernel plan's serving path, through the
    row-norm kernel, whose rows do not depend on the row count (its
    LayerNorm or RMSNorm mode).  Serving only: training keeps
    ``apply_norm``, as the reference leaves the norm to XLA."""
    b, s, d = x.shape
    if kind == "rmsnorm":
        y = K.rms_norm_rows(_rows(x), p["scale"])
    else:
        y = K.layer_norm_rows(_rows(x), p["scale"], p["bias"])
    return y.reshape(b, s, d)


def fused_ffn(x: torch.Tensor, p: Params, *, activation: str, gated: bool,
              norm_scale: Optional[torch.Tensor] = None,
              w8: int = 0) -> torch.Tensor:
    """GLU FFN through ``streamed_ffn``, or the ungated MLP through
    ``streamed_mlp``; with ``norm_scale`` the pre-FFN RMSNorm is folded
    into the kernel (``layers.py:795``).  ``w8``: weight-only int8 on
    every projection through the ``_w8`` twins (serving only)."""
    b, s, d = x.shape
    names = ("wg", "wu", "wd") if gated else ("wu", "wd")
    if w8:
        _refuse_w8_grad(x, norm_scale, *(p[n] for n in names))
        codes, scales = {}, {}
        for n in names:
            codes[n], scales[n + "_scale"] = w8_codes(p[n])
        fn = K.streamed_ffn_w8 if gated else K.streamed_mlp_w8
        y = fn(_rows(x), *(codes[n] for n in names), activation=activation,
               norm_scale=norm_scale, **scales)
        return y.reshape(b, s, d)
    kernel = K.streamed_ffn if gated else K.streamed_mlp
    args = (x,) + tuple(p[n] for n in names)
    if norm_scale is not None:
        args += (norm_scale,)

    def split(args):
        ws = args[1:1 + len(names)]
        norm = args[1 + len(names)] if norm_scale is not None else None
        return args[0], ws, norm

    def fused(*args):
        x, ws, norm = split(args)
        return kernel(_rows(x), *ws, activation=activation,
                      norm_scale=norm).reshape(b, s, d)

    def eager(*args):
        x, ws, norm = split(args)
        h = rms_norm(x, norm) if norm is not None else x
        return ffn(h, dict(zip(names, ws)), activation=activation,
                   gated=gated)

    return _kernel_fwd_eager_bwd(fused, eager)(*args)


def fused_moe_ffn(x: torch.Tensor, p: Params, *, activation: str,
                  top_k: int, block_t: int = 128,
                  router_kernel: bool = True) -> torch.Tensor:
    """The router outside the kernel, the experts through ``moe_experts``
    (K12; ``layers.py:872``, single device): x [B, S, D] -> [B, S, D].
    ``router_kernel``: the router product through ``block_matmul`` (the
    serving path, whose rows must not depend on the row count), else
    ``@`` (training, as the reference).  The eager backward recomputes
    ``moe_experts_eager`` from (x, gates, wg, wu, wd); the router's
    gradient flows through ``gates`` eagerly.  ``block_t`` is the plan's
    hint; the kernel picks its own tiles."""
    del block_t
    b, s, d = x.shape
    logits = fused_matmul(x, p["wr"]) if router_kernel else x @ p["wr"]
    gates = gates_from_logits(logits, top_k, x.dtype)

    def fused(x, gates, wg, wu, wd):
        return K.moe_experts(_rows(x), _rows(gates), wg, wu, wd,
                             activation=activation).reshape(b, s, d)

    def eager(x, gates, wg, wu, wd):
        return moe_experts_eager(x, gates, wg, wu, wd, activation=activation)

    return _kernel_fwd_eager_bwd(fused, eager)(x, gates, p["wg"], p["wu"],
                                              p["wd"])


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_kv: int = 512) -> torch.Tensor:
    """Whole-sequence attention through the static flash kernel
    (``layers.py:915``); its backward recomputes ``streaming_attention``."""

    def fused(q, k, v):
        return K.flash_attention(q, k, v, causal=causal, window=window,
                                 block_kv=block_kv)

    def eager(q, k, v):
        if window:
            raise NotImplementedError("eager local attention (sliding "
                                      "window) is not ported yet")
        return streaming_attention(q, k, v, causal=causal)

    return _kernel_fwd_eager_bwd(fused, eager)(q, k, v)


def fused_streamed_xent(hidden: torch.Tensor, head: torch.Tensor,
                        labels: torch.Tensor, vocab_size: int, *,
                        block_t: int = 128,
                        block_v: int = 512) -> torch.Tensor:
    """Mean cross-entropy through ``streamed_xent`` (``layers.py:1124``,
    single device): hidden [B, S, D], head [D, Vp], labels [B, S] with
    negative labels ignored.  The forward never holds the [T, Vp] logits;
    the backward recomputes them through the eager formulation, which
    rounds ``hidden @ head`` to the compute dtype before the float32 cast
    (the kernel does not), as the reference does.  ``block_t`` and
    ``block_v`` are the plan's hints; the kernel picks its own tiles."""
    del block_t, block_v
    b, s, d = hidden.shape

    def fused(hidden, head, labels):
        return K.streamed_xent_loss(_rows(hidden), head, labels.reshape(-1),
                                    vocab_size=vocab_size)

    def eager(hidden, head, labels):
        logits = (hidden.reshape(b * s, d) @ head).float()
        pad = torch.arange(logits.shape[-1],
                           device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
        lf = labels.reshape(-1)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1,
                            torch.clamp(lf, min=0).long()[:, None])[:, 0]
        return xent_nll_mean(lse, gold, lf)

    return _kernel_fwd_eager_bwd(fused, eager)(hidden, head, labels)


def fused_attention_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_offset: int, kv_len: int, *, causal: bool = True,
                          window: int = 0, block_kv: int = 512,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Chunked-prefill attention through the offset flash kernel; with
    ``k_scale``/``v_scale`` [B, Skv, Hkv] (per-position scales) k/v are
    codes and its quantized twin runs (``layers.py:949``)."""
    return K.flash_attention(q, k, v, q_offset=q_offset, kv_len=kv_len,
                             causal=causal, window=window, block_kv=block_kv,
                             k_scale=k_scale, v_scale=v_scale)


def fused_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor, *, window: int = 0,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Decode attention through the paged kernel (pools read in place);
    with ``k_scale``/``v_scale`` [P, Hkv] the pools hold codes and the
    quantized twin runs (``layers.py:993``)."""
    if k_scale is not None:
        return K.paged_decode_attention_q(q.contiguous(), k_pool, v_pool,
                                          page_table, lengths,
                                          k_scale=k_scale, v_scale=v_scale,
                                          window=window)
    return K.paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                    page_table, lengths, window=window)


def fused_verify_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           q_off: torch.Tensor, *, window: int = 0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Speculative-verify attention through the paged verify kernel: one
    launch scores every window row of every slot (``layers.py:1034``,
    single device); quantized pools as ``fused_paged_attention``."""
    if k_scale is not None:
        return K.paged_verify_attention_q(q.contiguous(), k_pool, v_pool,
                                          page_table, q_off,
                                          k_scale=k_scale, v_scale=v_scale,
                                          window=window)
    return K.paged_verify_attention(q.contiguous(), k_pool, v_pool,
                                    page_table, q_off, window=window)
