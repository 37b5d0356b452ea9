"""The language model's entry points: for serving, ``prefill_chunk``,
``decode_step`` and the speculative ``verify_step`` against the paged KV
cache, and the whole-prompt ``prefill`` whose fresh cache the engine
places into pages; for training, ``forward_hidden`` and ``forward_train``
(the streamed cross-entropy loss, ``model.py:349-447``).

Port of ``repro.models.model`` on the main paths.  Layers run as a Python
loop over ``params["layers"]`` (the reference scans over stacked pattern
groups).  The paged pools, and the contiguous slot cache that ``decode_step``
also takes (no page table), are updated in place; the entry points return the
cache object they were given, for symmetry with the reference, which returns
the updated (donated) tree.  K/V enter and leave the caches in the config's
``kv_cache_layout`` ("bshd" or "bhsd", transposed at the edges); the paged
pools are page-major under either.  Quirks kept from the reference: the ``x *
sqrt(d_model)`` embedding scale, learned positions added after that scale (pad
rows of a final chunk included), pad-vocab logits set to -1e30, and greedy
argmax returning the first maximum.

On the kernel plan every call on the path gives a row the same bits at any
row count up to 64 (a speculative verify dispatch of slots x W rows must
reproduce a decode step of slots rows): besides the plan's stages, the
o-projection and the LM head run through ``block_matmul`` (K5), the final
RMSNorm and the LM head through one ``rmsnorm_matmul`` (K3) call, and the
LayerNorms and the MoE family's ln2 RMSNorm through the row-norm kernel,
and the MoE router product through ``block_matmul``, where the reference
leaves them to XLA and the eager plan keeps ``torch.matmul`` and
PyTorch's norms.
Under a weight-quantizing config the o-projection and LM head stay at full
precision, as in the reference.

Quantized KV pools (a ``k_scale`` leaf in the cache) take the reference's
quantized branches: codes written through the quantize-on-write
primitives, read by the kernels' quantized twins on the kernel plan or
dequantized densely (``gather_pages_dequant``) on the eager plan.

Training keeps that routing for the serving entry points only.  On the
training path the plan's stages run their kernels with the eager backward
(``layers._kernel_fwd_eager_bwd``), and what the reference leaves to XLA
stays PyTorch ops with autograd: the o-projection ``@``, gpt2's
LayerNorms, the MoE family's ln2 and router product, and the final norm
(row invariance is a serving concern).
float32 master weights are cast to the compute dtype inside the forward
(the reference's ``_cast_tree``), so gradients flow back to the float32
leaves; ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` on the
scan body), which runs its kernels a second time.

Hybrid stacks (zamba2, ``model.py:219``, ``:302``, ``:852``, ``:916``):
every layer is a Mamba2 block (its norm, the projections and the causal
conv as PyTorch ops, the SSD scan through ``mamba2_scan`` (K13) on the
kernel plan), and after every ``shared_attn_every``-th one the single
``shared`` attention+MLP block runs with that application's K/V pools.
Whole-prompt ``prefill`` returns each layer's SSM state and conv tail
beside the K/V; ``decode_step`` advances them in place (the eager
single-token update, the conv tail in float32, as the reference).  The
shared block's gradient sums over its applications, as autograd does by
itself; under remat each layer's checkpoint covers its application.

Qwen stacks (qwen3-0.6b, qwen1.5-0.5b, qwen2-vl-2b) are the dense stack
with the reference's three additions, PyTorch ops on every plan as they
are XLA ops there: the QKV biases after the projections, qk-norm (an
RMSNorm over each head's q and k) before the rotary embedding, so the
pages hold normed, rotated K, and M-RoPE (qwen2-vl: three position axes,
a section of the rotary half dim each).  ``prefill`` and
``forward_hidden`` take a frontend's ``embeds`` with M-RoPE ``positions``
in place of tokens; decode gives a slot's one position to all three axes.
M-RoPE stacks are neither chunked nor speculative (a scalar chunk offset
cannot carry three position axes), as in the reference.

RWKV6 stacks (rwkv6-7b, ``model.py:251``, ``:878``): every layer is a
time mix (LayerNorm, token shift, the r/k/v/g/w projections, the wkv
recurrence, the gated output projection) and a channel mix (LayerNorm,
token shift, ``sigmoid(r) * (relu(k)^2 @ wv)``), all PyTorch ops but the
recurrence, which runs ``rwkv6_wkv`` (K14) on the kernel plan.  There is
no attention and no K/V: whole-prompt ``prefill`` returns each layer's
wkv state and the last normalised rows of both mixes (the carried token
shifts), and ``decode_step`` continues them in place with the eager
one-token recurrence, as the reference does (no kernel there).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.stream_plan import LayerPlan, StreamPlan, plan_for
from . import layers as L
from .params import (SHARED_KIND, attn_pool_indices, compute_dtype,
                     kv_seq_axis, map_tree)

Tree = Any
Cache = Dict[str, torch.Tensor]


def resolve_plan(cfg: ModelConfig, tokens: int, *,
                 kv_len: Optional[int] = None,
                 plan: Optional[StreamPlan] = None) -> Optional[StreamPlan]:
    """The StreamPlan driving kernel dispatch, or None for eager.  An
    explicit ``plan`` wins; otherwise ``cfg.use_fused_kernels`` selects
    the plan for this config."""
    if plan is not None:
        return plan
    if not cfg.use_fused_kernels:
        return None
    return plan_for(cfg, tokens, kv_len)


def _lplan(plan: Optional[StreamPlan], kind: str) -> Optional[LayerPlan]:
    return plan.layer(kind) if plan is not None else None


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Causal attention-only stacks with scalar positions (``:500``)."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    return (cfg.causal and cfg.rope != "mrope"
            and kinds <= {"attn", "local_attn", "global_attn"})


def _window(cfg: ModelConfig, i: int) -> int:
    return cfg.sliding_window if cfg.layer_kind(i) == "local_attn" else 0


def _embed(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Token embedding times sqrt(d_model), plus the learned position rows
    at ``positions`` (broadcast against tokens) under ``rope="none"``."""
    x = params["embed"][tokens.long()]
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                         device=x.device)
    if "pos_embed" in params:
        x = x + params["pos_embed"][positions.long()]
    return x


def _embed_in(cfg: ModelConfig, params: Tree, tokens: Optional[torch.Tensor],
              embeds: Optional[torch.Tensor],
              positions: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x [B, S, D], positions) of a whole sequence (``model.py:326``).
    ``embeds`` [B, S, D] (a frontend's patch or frame embeddings) enter as
    they are, cast to the compute dtype and not scaled; else the tokens go
    through ``_embed``.  Under M-RoPE the positions are ``positions`` [3,
    B, S] (temporal, height, width), by default the token positions on all
    three axes; else the token positions [B, S] (a given ``positions`` is
    ignored, as in the reference)."""
    src = tokens if embeds is None else embeds
    b, s = src.shape[:2]
    base = torch.arange(s, device=src.device)[None].expand(b, s)
    if cfg.rope != "mrope":
        positions = base
    elif positions is None:
        positions = base[None].expand(3, b, s)
    if embeds is None:
        return _embed(cfg, params, tokens, positions), positions
    x = embeds.to(compute_dtype(cfg))
    if "pos_embed" in params:
        x = x + params["pos_embed"][:s][None]
    return x, positions


def _qk_normed(cfg: ModelConfig, ap: Tree, q: torch.Tensor,
               k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """qk-norm (``model.py:105``): RMSNorm of each head's q and k over the
    head dim with the ``q_norm``/``k_norm`` scales, after the head reshape
    and before the rotary embedding, as PyTorch ops on every plan (the
    reference leaves it to XLA)."""
    if not cfg.qk_norm:
        return q, k
    return L.rms_norm(q, ap["q_norm"]), L.rms_norm(k, ap["k_norm"])


def _logits(cfg: ModelConfig, params: Tree, h: torch.Tensor,
            plan: Optional[StreamPlan]) -> torch.Tensor:
    """Final norm + LM head in float32, pad-vocab columns at -1e30.  On the
    kernel plan: one ``rmsnorm_matmul`` over the padded vocabulary (the
    normalised row rounded to h's dtype before the product, as
    ``apply_norm`` then ``@``), or the row-norm kernel then
    ``block_matmul``."""
    fn = params["final_norm"]
    if plan is None:
        logits = L.apply_norm(cfg.norm, h, fn) @ params["lm_head"]
    elif cfg.norm == "rmsnorm":
        logits = L.fused_norm_matmul(h, fn["scale"], params["lm_head"])
    else:
        logits = L.fused_matmul(L.fused_norm(cfg.norm, h, fn),
                                params["lm_head"])
    logits = logits.float()
    pad = torch.arange(logits.shape[-1], device=logits.device) \
        >= cfg.vocab_size
    return logits.masked_fill(pad, L.NEG_INF)


def _plan_norm(train: bool):
    """The norm in front of a kernel that does not fold it: the row-norm
    kernel when serving, PyTorch's when training (the reference's XLA
    norm, with autograd)."""
    return L.apply_norm if train else L.fused_norm


def _project_qkv(cfg: ModelConfig, p: Tree, x: torch.Tensor, ln_p: Tree,
                 lplan: Optional[LayerPlan], train: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ln + Q/K/V projections, eager or through the plan's kernel (three
    launches, one per projection, as the reference): ``rmsnorm_matmul``
    folds the norm in; under ``block_matmul`` the norm stays outside.
    Under ``qkv_bias`` the biases (never quantized) are added after the
    projections on every route (``model.py:139``)."""
    choice = lplan.qkv if lplan is not None else None
    if choice is not None and choice.fused:
        if choice.implementation == "rmsnorm_matmul":
            w8 = choice.kw.get("w8", 0)
            q, k, v = (L.fused_norm_matmul(x, ln_p["scale"], p[w], w8=w8)
                       for w in ("wq", "wk", "wv"))
        elif choice.implementation == "block_matmul":
            h = _plan_norm(train)(cfg.norm, x, ln_p)
            q, k, v = (L.fused_matmul(h, p[w]) for w in ("wq", "wk", "wv"))
        else:
            raise NotImplementedError(
                f"qkv kernel {choice.implementation!r} is not ported yet")
    else:
        h = L.apply_norm(cfg.norm, x, ln_p)
        q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _ffn_block(cfg: ModelConfig, p: Tree, x: torch.Tensor, ln_p: Tree,
               lplan: Optional[LayerPlan], train: bool = False
               ) -> torch.Tensor:
    """ln2 + FFN, eager or through ``streamed_ffn`` / ``streamed_mlp``;
    ``fuse_norm`` folds the RMSNorm into the kernel, else the norm stays
    outside.  MoE (``model.py:176-194``): ln2 outside, then the router and
    the experts (``moe_experts`` on the kernel plan)."""
    choice = lplan.ffn if lplan is not None else None
    if choice is not None and choice.fused:
        if choice.implementation == "moe_experts":
            return L.fused_moe_ffn(_plan_norm(train)(cfg.norm, x, ln_p), p,
                                   activation=cfg.activation,
                                   top_k=cfg.top_k, router_kernel=not train,
                                   **choice.kw)
        if choice.implementation not in ("streamed_ffn", "streamed_mlp"):
            raise NotImplementedError(
                f"ffn kernel {choice.implementation!r} is not ported yet")
        w8 = choice.kw.get("w8", 0)
        if choice.kw.get("fuse_norm", 0):
            return L.fused_ffn(x, p, activation=cfg.activation,
                               gated=cfg.gated_ffn,
                               norm_scale=ln_p["scale"], w8=w8)
        return L.fused_ffn(_plan_norm(train)(cfg.norm, x, ln_p), p,
                           activation=cfg.activation, gated=cfg.gated_ffn,
                           w8=w8)
    h = L.apply_norm(cfg.norm, x, ln_p)
    if cfg.is_moe:
        return L.moe_ffn(h, p, activation=cfg.activation,
                         gated=cfg.gated_ffn, top_k=cfg.top_k)
    return L.ffn(h, p, activation=cfg.activation, gated=cfg.gated_ffn)


def _out_proj(o: torch.Tensor, wo: torch.Tensor,
              lplan: Optional[LayerPlan], train: bool = False
              ) -> torch.Tensor:
    """The attention output projection: ``block_matmul`` on the kernel
    plan's serving path (its split depends on the weight shape alone),
    else ``@`` (the reference's, ``model.py:167``)."""
    if lplan is not None and not train:
        return L.fused_matmul(o, wo)
    return o @ wo


def _to_layout(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """K or V [B, S, Hkv, hd] in the config's cache layout: transposed to
    [B, Hkv, S, hd] under "bhsd" (a view), unchanged under "bshd"."""
    return t.transpose(1, 2) if cfg.kv_cache_layout == "bhsd" else t


def _layer_pools(cfg: ModelConfig, cache: Cache, layer: int):
    """(k, v, k_scale, v_scale) pools of one layer's attention (its row
    along the pools' leading axis, ``attn_pool_indices``), views updated
    in place; the scales are None for full-precision pools."""
    a = attn_pool_indices(cfg)[layer]
    if "k_scale" in cache:
        return (cache["k"][a], cache["v"][a],
                cache["k_scale"][a], cache["v_scale"][a])
    return cache["k"][a], cache["v"][a], None, None


def _attn_block_full(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                     positions: torch.Tensor, *, window: int,
                     lplan: Optional[LayerPlan], train: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One attention block over whole sequences (``model.py:144-216``);
    returns the block output and the layer's K/V for the decode cache.
    ``train``: the training path's routing (module docstring)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    ap = p["attn"]
    q, k, v = _project_qkv(cfg, ap, x, p["ln1"], lplan, train)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    q, k = _qk_normed(cfg, ap, q, k)
    q = L.apply_positional(cfg.rope, q, positions, cfg.rope_theta)
    k = L.apply_positional(cfg.rope, k, positions, cfg.rope_theta)
    choice = lplan.attention if lplan is not None else None
    if choice is not None and choice.fused:
        o = L.fused_attention(q, k, v, causal=cfg.causal, window=window,
                              block_kv=choice.kw["block_kv"])
    elif window:
        o = L.local_attention(q, k, v, window=window,
                              remat_chunk=cfg.remat_attn_chunk)
    else:
        o = L.streaming_attention(q, k, v, causal=cfg.causal,
                                  remat_chunk=cfg.remat_attn_chunk)
    x = x + _out_proj(o.reshape(b, s, hq * hd), ap["wo"], lplan, train)
    return x + _ffn_block(cfg, p["mlp"], x, p["ln2"], lplan, train), k, v


def _mamba_block_full(cfg: ModelConfig, p: Tree, x: torch.Tensor, *,
                      lplan: Optional[LayerPlan]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Mamba2 block over whole sequences (``model.py:219``): ln, the
    x/z/B/C/dt projections, the causal conv, the SSD scan (``mamba2_scan``
    on the kernel plan, chunk ``_chunk_of(S, 128)``), the SiLU gate and the
    output projection.  Returns the block output, the final SSM state [B,
    H, P, N] float32 and the conv tail [B, K - 1, d_inner]."""
    b, s, _ = x.shape
    m = p["mamba"]
    h = L.apply_norm(cfg.norm, x, p["ln"])
    xin = h @ m["wx"]                                       # [B,S,di]
    z = h @ m["wz"]
    bmat = h @ m["wb"]                                      # [B,S,N]
    cmat = h @ m["wc"]
    dt = torch.nn.functional.softplus(h @ m["wdt"]
                                      + m["dt_bias"].to(h.dtype))
    xconv, conv_tail = L.causal_conv1d(xin, m["conv_w"], m["conv_b"])
    hps = xconv.reshape(b, s, cfg.ssm_heads, cfg.ssm_head_dim)
    mixer = lplan.mixer if lplan is not None else None
    if mixer is not None and mixer.fused:
        y, state = L.fused_mamba2_ssd(
            hps, dt, m["a_log"], bmat, cmat, m["d_skip"],
            chunk=_chunk_of(s, mixer.kw.get("chunk", 128)))
    else:
        y, state = L.mamba2_ssd(hps, dt, m["a_log"], bmat, cmat,
                                m["d_skip"], chunk=_chunk_of(s, 128))
    y = y.reshape(b, s, cfg.d_inner) * torch.nn.functional.silu(z)
    return x + y @ m["wout"], state.float(), conv_tail


def _rwkv_block(cfg: ModelConfig, p: Tree, x: torch.Tensor, *,
                lplan: Optional[LayerPlan],
                carry: Optional[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """One RWKV6 block (``model.py:251``; ``:878`` with ``carry``): the
    time mix then the channel mix.  x [B, S, D]; ``carry`` (wkv [B, H, N,
    N], tm_shift [B, D], cm_shift [B, D]) continues a cached sequence by
    one token through the eager ``wkv6`` (decode), else the recurrence
    starts at zero and runs ``rwkv6_wkv`` on the kernel plan (chunk
    ``_chunk_of(S, 64)``), ``wkv6_chunked`` under ``cfg.rwkv_chunk``, or
    the eager ``wkv6``.  Returns the block output, the final wkv state
    float32 and the last normalised row of each mix (the next token's
    shifts), in x's dtype."""
    b, s, d = x.shape
    h, n = cfg.rwkv_heads, cfg.rwkv_head_dim
    tm, cm = p["tm"], p["cm"]
    state, tm_prev, cm_prev = carry if carry is not None else (None,) * 3

    def prev(row, like):
        return None if row is None else row.to(like.dtype)[:, None]

    xa = L.apply_norm(cfg.norm, x, p["ln1"])
    xs = L.token_shift(xa, prev(tm_prev, xa))

    def mix(name):
        mu = tm[f"mix_{name}"].to(xa.dtype)
        return xa * mu + xs * (1.0 - mu)

    r = (mix("r") @ tm["wr"]).reshape(b, s, h, n)
    k = (mix("k") @ tm["wk"]).reshape(b, s, h, n)
    v = (mix("v") @ tm["wv"]).reshape(b, s, h, n)
    g = torch.nn.functional.silu(mix("g") @ tm["wg"])
    wdec = torch.exp(-torch.exp(
        (mix("w") @ tm["ww"]).float()
        + tm["w_bias"].reshape(1, 1, h * n))).reshape(b, s, h, n)
    mixer = lplan.mixer if lplan is not None else None
    if carry is not None:
        y, state = L.wkv6(r, k, v, wdec, tm["u"], init_state=state)
    elif mixer is not None and mixer.fused:
        y, state = L.fused_wkv6(r, k, v, wdec, tm["u"],
                                chunk=_chunk_of(s, mixer.kw.get("chunk", 64)))
    elif cfg.rwkv_chunk > 0:
        y, state = L.wkv6_chunked(r, k, v, wdec, tm["u"],
                                  chunk=cfg.rwkv_chunk)
    else:
        y, state = L.wkv6(r, k, v, wdec, tm["u"])
    x = x + (y.reshape(b, s, d) * g) @ tm["wo"]
    xc = L.apply_norm(cfg.norm, x, p["ln2"])
    xcs = L.token_shift(xc, prev(cm_prev, xc))

    def cmix(name):
        mu = cm[f"mix_{name}"].to(xc.dtype)
        return xc * mu + xcs * (1.0 - mu)

    kk = torch.square(torch.relu(cmix("k") @ cm["wk"]))
    rr = torch.sigmoid(cmix("r") @ cm["wr"])
    return x + rr * (kk @ cm["wv"]), state, xa[:, -1], xc[:, -1]


def prefill(params: Tree, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None, *,
            embeds: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            plan: Optional[StreamPlan] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Whole-prompt forward pass (``model.py:457``).

    tokens [B, S] int32, or ``embeds`` [B, S, D] (with M-RoPE
    ``positions`` [3, B, S]; ``_embed_in``) -> (logits [B, 1, Vp] at the
    last position, a fresh cache: {"k", "v"} [L_attn, B, S, Hkv, hd] of the
    prompt's K/V ([L_attn, B, Hkv, S, hd] under "bhsd"), which
    ``serving.kv_cache.place_prefill`` writes into a slot's pages (the
    engine's contiguous cache: into its slot rows), for a Mamba2 stack {"ssm"
    [L, B, H, P, N] float32, "conv" [L, B, K - 1, d_inner]}, and for an RWKV6
    stack {"wkv" [L, B, H, N, N] float32, "tm_shift", "cm_shift" [L, B, D]}
    alone, which it writes into the slot's rows)."""
    x, positions = _embed_in(cfg, params, tokens, embeds, positions)
    b, s = x.shape[:2]
    plan = resolve_plan(cfg, b * s, plan=plan)
    fresh: Dict[str, list] = {}
    for i, lp in enumerate(params["layers"]):
        kind = cfg.layer_kind(i)
        lplan = _lplan(plan, kind)
        if kind == "rwkv":
            x, *rows = _rwkv_block(cfg, lp, x, lplan=lplan)
            for name, t in zip(("wkv", "tm_shift", "cm_shift"), rows):
                fresh.setdefault(name, []).append(t)
            continue
        if kind.startswith("mamba"):
            x, ssm, conv = _mamba_block_full(cfg, lp, x, lplan=lplan)
            fresh.setdefault("ssm", []).append(ssm)
            fresh.setdefault("conv", []).append(conv)
            if kind != SHARED_KIND:
                continue
            lp = params["shared"]
        x, k, v = _attn_block_full(cfg, lp, x, positions,
                                   window=_window(cfg, i), lplan=lplan)
        fresh.setdefault("k", []).append(_to_layout(k, cfg))
        fresh.setdefault("v", []).append(_to_layout(v, cfg))
    logits = _logits(cfg, params, x[:, -1:], plan)
    return logits, {name: torch.stack(t) for name, t in fresh.items()}


# --------------------------------------------------------------------- #
# Training: hidden states and the streamed cross-entropy loss
# --------------------------------------------------------------------- #

def _cast_tree(cfg: ModelConfig, params: Tree) -> Tree:
    """float32 leaves cast to the compute dtype (``model.py:89``); the cast
    is differentiable, so gradients reach float32 master weights."""
    dt = compute_dtype(cfg)
    return map_tree(lambda a: a.to(dt) if a.dtype == torch.float32 else a,
                    params)


def _chunk_of(n: int, want: int) -> int:
    """The largest chunk <= ``want`` dividing ``n`` (``model.py:94``)."""
    c = min(want, n)
    while n % c:
        c = math.gcd(n, c)
    return max(1, c)


def forward_hidden(params: Tree, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], *, remat: bool = True,
                   plan: Optional[StreamPlan] = None) -> torch.Tensor:
    """Embedding + every block + final norm -> hidden states [B, S, D]
    (``model.py:349``).  ``batch["tokens"]`` [B, S] int, or a frontend's
    ``batch["embeds"]`` [B, S, D] with, under M-RoPE, ``batch["positions"]``
    [3, B, S] (``_embed_in``); ``remat`` wraps each layer in
    ``torch.utils.checkpoint`` (non-reentrant), so its activations are
    recomputed in the backward."""
    params = _cast_tree(cfg, params)
    x, positions = _embed_in(cfg, params, batch.get("tokens"),
                             batch.get("embeds"), batch.get("positions"))
    b, s = x.shape[:2]
    plan = resolve_plan(cfg, b * s, plan=plan)
    for i, lp in enumerate(params["layers"]):
        def block(x, lp=lp, i=i):
            kind = cfg.layer_kind(i)
            lplan = _lplan(plan, kind)
            if kind == "rwkv":
                return _rwkv_block(cfg, lp, x, lplan=lplan)[0]
            if kind.startswith("mamba"):
                x = _mamba_block_full(cfg, lp, x, lplan=lplan)[0]
                if kind != SHARED_KIND:
                    return x
                lp = params["shared"]
            return _attn_block_full(cfg, lp, x, positions,
                                    window=_window(cfg, i), lplan=lplan,
                                    train=True)[0]
        x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
    return L.apply_norm(cfg.norm, x, params["final_norm"])


def streamed_xent(hidden: torch.Tensor, head: torch.Tensor,
                  labels: torch.Tensor, vocab_size: int,
                  chunk: int = 256) -> torch.Tensor:
    """Mean cross-entropy over ``labels >= 0``, chunked over the sequence
    (the eager plan's loss, ``model.py:403``): hidden [B, S, D], head
    [D, Vp], labels [B, S] with -100 = ignore.  Each chunk's logits are
    ``hidden @ head`` in the compute dtype, then float32."""
    s = hidden.shape[1]
    c = _chunk_of(s, chunk)
    pad = torch.arange(head.shape[-1], device=hidden.device) >= vocab_size
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(0, s, c):
        y = labels[:, i:i + c]
        logits = (hidden[:, i:i + c] @ head).float().masked_fill(pad,
                                                                  L.NEG_INF)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            torch.clamp(y, min=0).long()[..., None])[..., 0]
        valid = y >= 0
        tot = tot + torch.where(valid, lse - gold, 0.0).sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1)


def forward_train(params: Tree, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor], *, remat: bool = True,
                  plan: Optional[StreamPlan] = None) -> torch.Tensor:
    """The streamed cross-entropy training loss (``model.py:435``): batch
    ``{"tokens", "labels"}`` [B, S] int, -100 = ignore (or ``embeds`` and
    ``positions`` in place of the tokens, as ``forward_hidden``).  On the
    kernel plan the loss runs through ``streamed_xent`` (K11), else
    eagerly."""
    labels = batch["labels"]
    plan = resolve_plan(cfg, labels.numel(), plan=plan)
    hidden = forward_hidden(params, cfg, batch, remat=remat, plan=plan)
    head = params["lm_head"].to(compute_dtype(cfg))
    if plan is not None and plan.lm_head.fused:
        return L.fused_streamed_xent(hidden, head, labels, cfg.vocab_size,
                                     **plan.lm_head.kw)
    return streamed_xent(hidden, head, labels, cfg.vocab_size)


def _attn_block_chunk(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                      cache: Cache, layer: int, table_row: torch.Tensor,
                      chunk_pages: torch.Tensor, offset: int, kv_len: int,
                      *, window: int, lplan: Optional[LayerPlan]
                      ) -> torch.Tensor:
    """One attention block over a prompt chunk against the paged cache
    (``model.py:517``): the chunk's K/V are written into their pages
    first, then attention gathers the slot's pages (dead pages re-routed
    to NULL) and masks at absolute positions and ``kv_len``.  Quantized
    pools (``model.py:566-619``): the kernel reads the gathered codes with
    per-position scales, the eager path dense dequantized K/V."""
    # Function-local: serving imports models at module load (as in the
    # reference, the page primitives live beside the allocator).
    from ..serving.kv_cache import (gather_pages, live_page_table,
                                    place_chunk_pages, place_chunk_pages_q)
    b, c, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    layout = cfg.kv_cache_layout
    ap = p["attn"]
    q, k, v = _project_qkv(cfg, ap, x, p["ln1"], lplan)
    q = q.reshape(b, c, hq, hd)
    k = k.reshape(b, c, hkv, hd)
    v = v.reshape(b, c, hkv, hd)
    q, k = _qk_normed(cfg, ap, q, k)
    positions = offset + torch.arange(c, device=x.device)[None]
    q = L.apply_positional(cfg.rope, q, positions, cfg.rope_theta)
    k = L.apply_positional(cfg.rope, k, positions, cfg.rope_theta)
    kc, vc, ks, vs = _layer_pools(cfg, cache, layer)
    k_new, v_new = _to_layout(k, cfg), _to_layout(v, cfg)
    quant = ks is not None
    if quant:
        place_chunk_pages_q(kc, ks, k_new, chunk_pages, layout=layout)
        place_chunk_pages_q(vc, vs, v_new, chunk_pages, layout=layout)
    else:
        place_chunk_pages(kc, k_new, chunk_pages, layout=layout)
        place_chunk_pages(vc, v_new, chunk_pages, layout=layout)
    row_live = live_page_table(table_row, kv_len, kc.shape[1])
    choice = lplan.attention if lplan is not None else None
    # Both attention routes take [1, S, Hkv, hd]: gather page-major
    # ("bshd") under either layout, which is the reference's "bhsd"
    # gather transposed back (``model.py:592-594``).
    if choice is not None and choice.fused:
        kseq = gather_pages(kc, row_live[None], layout="bshd")
        vseq = gather_pages(vc, row_live[None], layout="bshd")
        # Codes: each position carries its page's scale (``:606``).
        scl = {}
        if quant:
            ps, live = kc.shape[1], row_live.long()
            scl = {"k_scale": ks[live].repeat_interleave(ps, 0)[None],
                   "v_scale": vs[live].repeat_interleave(ps, 0)[None]}
        o = L.fused_attention_chunk(q, kseq, vseq, offset, kv_len,
                                    causal=cfg.causal, window=window,
                                    block_kv=choice.kw["block_kv"], **scl)
    else:
        kseq, vseq = _dense_kv(kc, vc, ks, vs, row_live[None], "bshd")
        o = L.streaming_attention(q, kseq, vseq, causal=cfg.causal,
                                  q_offset=offset, window=window,
                                  kv_len=kv_len)
    x = x + _out_proj(o.reshape(b, c, hq * hd), ap["wo"], lplan)
    return x + _ffn_block(cfg, p["mlp"], x, p["ln2"], lplan)


def prefill_chunk(params: Tree, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Cache, table_row: torch.Tensor,
                  chunk_pages: torch.Tensor, offset: int, last_idx: int, *,
                  plan: Optional[StreamPlan] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """Process one fixed-size prompt chunk against the paged cache.

    tokens [1, C] (zero-padded past the prompt on the final chunk); cache
    the pools {"k", "v"} [L, P, ps, Hkv, hd], updated in place;
    table_row [max_pages] int32; chunk_pages [C // ps] int32 physical
    pages of this chunk; offset the chunk's page-aligned start position;
    last_idx the within-chunk index of the prompt's last token.  Returns
    (next_token [1, 1] int32, logits [1, 1, Vp] at ``last_idx``, cache).
    """
    if not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"chunked prefill unsupported for config {cfg.name!r}")
    b, c = tokens.shape
    positions = int(offset) + torch.arange(c, device=tokens.device)[None]
    x = _embed(cfg, params, tokens, positions)
    kv_extent = int(table_row.shape[0]) * int(cache["k"].shape[2])
    plan = resolve_plan(cfg, b * c, kv_len=kv_extent, plan=plan)
    kv_len = int(offset) + c
    for i, lp in enumerate(params["layers"]):
        x = _attn_block_chunk(cfg, lp, x, cache, i, table_row, chunk_pages,
                              int(offset), kv_len, window=_window(cfg, i),
                              lplan=_lplan(plan, cfg.layer_kind(i)))
    logits = _logits(cfg, params, x[:, last_idx:last_idx + 1], plan)
    return logits.argmax(dim=-1).to(torch.int32), logits, cache


def _attn_block_decode(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                       cache: Cache, layer: int, pos: torch.Tensor,
                       lengths: torch.Tensor,
                       page_table: Optional[torch.Tensor], *,
                       window: int, lplan: Optional[LayerPlan]
                       ) -> torch.Tensor:
    """One attention block for one token per slot (``model.py:752``).
    With a page table: append the token's K/V through it, then attend
    through the paged kernel or the gather-pages eager path; over
    quantized pools through the quantize-on-write append and the kernel's
    quantized twin or dense dequantized K/V (``model.py:793-848``).
    Without one (the contiguous slot cache): write each slot's row at
    ``min(pos, S - 1)`` of its K/V leaves (a slot at capacity rewrites its
    last row; the engine retires it there) and attend with the plain
    ``decode_attention`` on every plan, as the reference
    (``model.py:827-843``)."""
    from ..serving.kv_cache import (live_page_table, paged_append,
                                    paged_append_q, to_page_major)
    b = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    layout = cfg.kv_cache_layout
    ap = p["attn"]
    q, k, v = _project_qkv(cfg, ap, x, p["ln1"], lplan)
    q = q.reshape(b, 1, hq, hd)
    k = k.reshape(b, 1, hkv, hd)
    v = v.reshape(b, 1, hkv, hd)
    q, k = _qk_normed(cfg, ap, q, k)
    # One position per slot; M-RoPE's three axes all at it (``:778``).
    pos_q = pos[:, None]
    if cfg.rope == "mrope":
        pos_q = pos_q[None].expand(3, b, 1)
    q = L.apply_positional(cfg.rope, q, pos_q, cfg.rope_theta)
    k = L.apply_positional(cfg.rope, k, pos_q, cfg.rope_theta)
    kc, vc, ks, vs = _layer_pools(cfg, cache, layer)
    if page_table is None:
        rows = torch.arange(b, device=x.device)
        for leaf, new in ((kc, k), (vc, v)):
            seq = to_page_major(leaf, layout)       # [B, S, Hkv, hd] view
            at = pos.long().clamp(max=seq.shape[1] - 1)
            seq[rows, at] = new[:, 0].to(leaf.dtype)
        o = L.decode_attention(q, kc, vc, lengths + 1, window=window,
                               layout=layout)
    else:
        k_new, v_new = _to_layout(k, cfg), _to_layout(v, cfg)
        if ks is not None:
            paged_append_q(kc, ks, page_table, pos, k_new, layout=layout)
            paged_append_q(vc, vs, page_table, pos, v_new, layout=layout)
        else:
            paged_append(kc, page_table, pos, k_new, layout=layout)
            paged_append(vc, page_table, pos, v_new, layout=layout)
        choice = lplan.decode_attn if lplan is not None else None
        if choice is not None and choice.fused:
            o = L.fused_paged_attention(q, kc, vc, page_table, lengths + 1,
                                        window=window, k_scale=ks,
                                        v_scale=vs)
        else:
            tbl_live = live_page_table(page_table, lengths + 1, kc.shape[1])
            kd, vd = _dense_kv(kc, vc, ks, vs, tbl_live, layout)
            o = L.decode_attention(q, kd, vd, lengths + 1, window=window,
                                   layout=layout)
    x = x + _out_proj(o.reshape(b, 1, hq * hd), ap["wo"], lplan)
    return x + _ffn_block(cfg, p["mlp"], x, p["ln2"], lplan)


def _mamba_block_decode(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                        cache: Cache, layer: int) -> torch.Tensor:
    """One Mamba2 block for one token per slot (``model.py:852``): the
    conv over the cached K - 1 inputs and this one in float32, then the
    single-token SSM update; the layer's ``ssm`` and ``conv`` rows are
    updated in place."""
    b = x.shape[0]
    m = p["mamba"]
    h = L.apply_norm(cfg.norm, x, p["ln"])[:, 0]            # [B,D]
    xin = h @ m["wx"]
    z = h @ m["wz"]
    bmat = h @ m["wb"]
    cmat = h @ m["wc"]
    dt = torch.nn.functional.softplus(h @ m["wdt"]
                                      + m["dt_bias"].to(h.dtype))
    conv_c = cache["conv"][layer]                           # [B,K-1,di]
    conv_in = torch.cat([conv_c, xin[:, None].to(conv_c.dtype)], dim=1)
    y = (conv_in.float() * m["conv_w"].float()[None]).sum(dim=1)
    xconv = torch.nn.functional.silu(
        y + m["conv_b"].float()).to(x.dtype)
    hps = xconv.reshape(b, cfg.ssm_heads, cfg.ssm_head_dim)
    ssm_c = cache["ssm"][layer]
    yssm, state = L.mamba2_decode_step(hps, dt, m["a_log"], bmat, cmat,
                                       m["d_skip"], ssm_c)
    ssm_c.copy_(state)
    conv_c.copy_(conv_in[:, 1:])
    yin = yssm.reshape(b, cfg.d_inner) * torch.nn.functional.silu(z)
    return x + (yin @ m["wout"])[:, None]


def _dense_kv(kc, vc, ks, vs, table, layout):
    """The eager plan's dense per-slot K/V: gathered pages, dequantized to
    float32 for code pools."""
    from ..serving.kv_cache import gather_pages, gather_pages_dequant
    if ks is None:
        return (gather_pages(kc, table, layout=layout),
                gather_pages(vc, table, layout=layout))
    return (gather_pages_dequant(kc, ks, table, layout=layout),
            gather_pages_dequant(vc, vs, table, layout=layout))


def decode_step(params: Tree, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Cache, cache_pos: torch.Tensor,
                lengths: torch.Tensor, *,
                page_table: Optional[torch.Tensor] = None,
                plan: Optional[StreamPlan] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """One decoding step for every slot (``model.py:941``).

    tokens [B, 1] int32; cache the paged pools with page_table [B,
    max_pages] int32, or without a table the contiguous slot cache
    (``params.init_cache``: K/V leaves [L_attn, B, S, Hkv, hd], [L_attn,
    B, Hkv, S, hd] under "bhsd"), and a Mamba2 or RWKV6 stack's
    slot-contiguous state rows, all updated in place; cache_pos [B] int32
    write positions; lengths [B] int32 tokens already cached.  Returns
    (next_tokens [B, 1] int32, logits [B, 1, Vp], cache).  The plan sees
    the table's extent or the cache's length as its KV extent, none
    without K/V (RWKV6), as the reference's ``_cache_kv_len``."""
    b = tokens.shape[0]
    x = _embed(cfg, params, tokens, cache_pos[:, None])
    if "k" not in cache:
        kv_extent = None
    elif page_table is not None:
        kv_extent = int(page_table.shape[1]) * int(cache["k"].shape[2])
    else:
        kv_extent = int(cache["k"].shape[kv_seq_axis(cfg.kv_cache_layout)])
    plan = resolve_plan(cfg, b, kv_len=kv_extent, plan=plan)
    for i, lp in enumerate(params["layers"]):
        kind = cfg.layer_kind(i)
        if kind == "rwkv":
            rows = tuple(cache[n][i] for n in ("wkv", "tm_shift",
                                               "cm_shift"))
            x, *new = _rwkv_block(cfg, lp, x, lplan=None, carry=rows)
            for row, t in zip(rows, new):
                row.copy_(t)
            continue
        if kind.startswith("mamba"):
            x = _mamba_block_decode(cfg, lp, x, cache, i)
            if kind != SHARED_KIND:
                continue
            lp = params["shared"]
        x = _attn_block_decode(cfg, lp, x, cache, i, cache_pos, lengths,
                               page_table, window=_window(cfg, i),
                               lplan=_lplan(plan, kind))
    logits = _logits(cfg, params, x, plan)
    return logits.argmax(dim=-1).to(torch.int32), logits, cache


# --------------------------------------------------------------------- #
# Speculative verify (draft-then-verify decode, DESIGN.md §11)
# --------------------------------------------------------------------- #

def supports_speculative(cfg: ModelConfig) -> bool:
    """Whether ``verify_step`` can serve ``cfg`` (``model.py:1009``): a
    rejected draft must be undoable, which paged K/V is (a page-table
    edit) and recurrent state is not; the rest are the chunked-prefill
    conditions (causal masking scopes each window row to its own
    prefix)."""
    return supports_chunked_prefill(cfg)


def _attn_block_verify(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                       cache: Cache, layer: int, pos0: torch.Tensor,
                       lengths: torch.Tensor, page_table: torch.Tensor, *,
                       window: int, lplan: Optional[LayerPlan]
                       ) -> torch.Tensor:
    """One attention block over a W-token verify window (``model.py:1023``).

    x [B, W, D]: the pending token plus W - 1 drafts per slot.  K/V rows
    land at ``pos0 .. pos0 + W - 1`` and window row i attends through
    ``pos0 + i``, the extent decode would see after consuming i accepted
    tokens.  Rows past the accepted prefix leave stale K/V behind, beyond
    every slot's length: the engine rolls them back and later writes
    overwrite them.  Quantized pools as in decode (``model.py:1045-1097``);
    the rejected rows' scale growth stays, as in the reference."""
    from ..serving.kv_cache import (live_page_table, paged_append_window,
                                    paged_append_window_q)
    b, w, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    layout = cfg.kv_cache_layout
    ap = p["attn"]
    q, k, v = _project_qkv(cfg, ap, x, p["ln1"], lplan)
    q = q.reshape(b, w, hq, hd)
    k = k.reshape(b, w, hkv, hd)
    v = v.reshape(b, w, hkv, hd)
    q, k = _qk_normed(cfg, ap, q, k)
    pos = pos0[:, None] + torch.arange(w, device=x.device)[None]
    q = L.apply_positional(cfg.rope, q, pos, cfg.rope_theta)
    k = L.apply_positional(cfg.rope, k, pos, cfg.rope_theta)
    kc, vc, ks, vs = _layer_pools(cfg, cache, layer)
    k_new, v_new = _to_layout(k, cfg), _to_layout(v, cfg)
    if ks is not None:
        paged_append_window_q(kc, ks, page_table, pos0, k_new, layout=layout)
        paged_append_window_q(vc, vs, page_table, pos0, v_new, layout=layout)
    else:
        paged_append_window(kc, page_table, pos0, k_new, layout=layout)
        paged_append_window(vc, page_table, pos0, v_new, layout=layout)
    choice = lplan.verify_attn if lplan is not None else None
    if choice is not None and choice.fused:
        o = L.fused_verify_attention(q, kc, vc, page_table, lengths,
                                     window=window, k_scale=ks, v_scale=vs)
    else:
        tbl_live = live_page_table(page_table, lengths + w, kc.shape[1])
        kd, vd = _dense_kv(kc, vc, ks, vs, tbl_live, layout)
        o = L.verify_attention(q, kd, vd, lengths, window=window,
                               layout=layout)
    x = x + _out_proj(o.reshape(b, w, hq * hd), ap["wo"], lplan)
    return x + _ffn_block(cfg, p["mlp"], x, p["ln2"], lplan)


def verify_step(params: Tree, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Cache, cache_pos: torch.Tensor,
                lengths: torch.Tensor, *, page_table: torch.Tensor,
                plan: Optional[StreamPlan] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """Score a W-token speculative window in one dispatch (``:1117``).

    tokens [B, W] int32: column 0 the pending input token, columns 1..W-1
    the drafts; cache the paged pools, updated in place; cache_pos [B]
    int32 the window's first write position; lengths [B] int32 tokens
    already cached (== cache_pos on the serving path); page_table
    [B, max_pages].  Returns (greedy [B, W] int32, logits [B, W, Vp],
    cache): ``greedy[:, i]`` is the model's next token after
    ``tokens[:, :i + 1]``, and every row's logits are the ones decode
    would produce there."""
    if not supports_speculative(cfg):
        raise NotImplementedError(
            f"speculative verify unsupported for config {cfg.name!r}")
    b, w = tokens.shape
    pos = cache_pos[:, None] + torch.arange(w, device=tokens.device)[None]
    x = _embed(cfg, params, tokens, pos)
    kv_extent = int(page_table.shape[1]) * int(cache["k"].shape[2])
    plan = resolve_plan(cfg, b * w, kv_len=kv_extent, plan=plan)
    for i, lp in enumerate(params["layers"]):
        x = _attn_block_verify(cfg, lp, x, cache, i, cache_pos, lengths,
                               page_table, window=_window(cfg, i),
                               lplan=_lplan(plan, cfg.layer_kind(i)))
    logits = _logits(cfg, params, x, plan)
    return logits.argmax(dim=-1).to(torch.int32), logits, cache
