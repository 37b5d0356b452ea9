"""The language model's serving entry points: ``prefill_chunk`` and
``decode_step`` against the paged KV cache, and the whole-prompt
``prefill`` whose fresh cache the engine places into pages.

Port of ``repro.models.model`` on the main paths.  Layers run as a Python
loop over ``params["layers"]`` (the reference scans over stacked pattern
groups).  The paged pools are updated in place; both entry points return
the cache object they were given, for symmetry with the reference, which
returns the updated (donated) tree.  Quirks kept from the reference: the
``x * sqrt(d_model)`` embedding scale, learned positions added after that
scale (pad rows of a final chunk included), pad-vocab logits set to
-1e30, and greedy argmax returning the first maximum.  The o-projection
and the LM head are plain ``torch.matmul`` as the reference leaves them to
XLA.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.stream_plan import LayerPlan, StreamPlan, plan_for
from . import layers as L

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


def _logits(cfg: ModelConfig, params: Tree, h: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head in float32, pad-vocab columns at -1e30."""
    h = L.apply_norm(cfg.norm, h, params["final_norm"])
    logits = (h @ params["lm_head"]).float()
    pad = torch.arange(logits.shape[-1], device=logits.device) \
        >= cfg.vocab_size
    return logits.masked_fill(pad, L.NEG_INF)


def _project_qkv(cfg: ModelConfig, p: Tree, x: torch.Tensor, ln_p: Tree,
                 lplan: Optional[LayerPlan]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ln + Q/K/V projections, eager or through the plan's kernel (three
    launches, one per projection, as the reference): ``rmsnorm_matmul``
    folds the norm in; under ``block_matmul`` the norm stays eager."""
    choice = lplan.qkv if lplan is not None else None
    if choice is not None and choice.fused:
        if choice.implementation == "rmsnorm_matmul":
            return tuple(L.fused_norm_matmul(x, ln_p["scale"], p[w])
                         for w in ("wq", "wk", "wv"))
        if choice.implementation != "block_matmul":
            raise NotImplementedError(
                f"qkv kernel {choice.implementation!r} is not ported yet")
        h = L.apply_norm(cfg.norm, x, ln_p)
        return tuple(L.fused_matmul(h, p[w]) for w in ("wq", "wk", "wv"))
    h = L.apply_norm(cfg.norm, x, ln_p)
    return h @ p["wq"], h @ p["wk"], h @ p["wv"]


def _ffn_block(cfg: ModelConfig, p: Tree, x: torch.Tensor, ln_p: Tree,
               lplan: Optional[LayerPlan]) -> torch.Tensor:
    """ln2 + FFN, eager or through ``streamed_ffn`` / ``streamed_mlp``;
    ``fuse_norm`` folds the RMSNorm into the kernel, else the norm stays
    eager."""
    choice = lplan.ffn if lplan is not None else None
    if choice is not None and choice.fused:
        if choice.implementation not in ("streamed_ffn", "streamed_mlp"):
            raise NotImplementedError(
                f"ffn kernel {choice.implementation!r} is not ported yet")
        if choice.kw.get("fuse_norm", 0):
            return L.fused_ffn(x, p, activation=cfg.activation,
                               gated=cfg.gated_ffn,
                               norm_scale=ln_p["scale"])
        return L.fused_ffn(L.apply_norm(cfg.norm, x, ln_p), p,
                           activation=cfg.activation, gated=cfg.gated_ffn)
    return L.ffn(L.apply_norm(cfg.norm, x, ln_p), p,
                 activation=cfg.activation, gated=cfg.gated_ffn)


def _attn_block_full(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                     positions: torch.Tensor, *, window: int,
                     lplan: Optional[LayerPlan]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One attention block over whole sequences (``model.py:144-216``);
    returns the block output and the layer's K/V for the decode cache."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    ap = p["attn"]
    q, k, v = _project_qkv(cfg, ap, x, p["ln1"], lplan)
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    q = L.apply_positional(cfg.rope, q, positions, cfg.rope_theta)
    k = L.apply_positional(cfg.rope, k, positions, cfg.rope_theta)
    choice = lplan.attention if lplan is not None else None
    if choice is not None and choice.fused:
        o = L.fused_attention(q, k, v, causal=cfg.causal, window=window,
                              block_kv=choice.kw["block_kv"])
    elif window:
        raise NotImplementedError("eager local attention (sliding window) "
                                  "is not ported yet")
    else:
        o = L.streaming_attention(q, k, v, causal=cfg.causal)
    x = x + o.reshape(b, s, hq * hd) @ ap["wo"]
    return x + _ffn_block(cfg, p["mlp"], x, p["ln2"], lplan), k, v


def prefill(params: Tree, cfg: ModelConfig, tokens: torch.Tensor, *,
            plan: Optional[StreamPlan] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Whole-prompt forward pass (``model.py:457``).

    tokens [B, S] int32 -> (logits [B, 1, Vp] at the last position, a
    fresh cache {"k", "v"} [L, B, S, Hkv, hd] of the prompt's K/V, which
    ``serving.kv_cache.place_prefill`` writes into a slot's pages)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed(cfg, params, tokens, positions)
    plan = resolve_plan(cfg, b * s, plan=plan)
    ks, vs = [], []
    for i, lp in enumerate(params["layers"]):
        x, k, v = _attn_block_full(cfg, lp, x, positions,
                                   window=_window(cfg, i),
                                   lplan=_lplan(plan, cfg.layer_kind(i)))
        ks.append(k)
        vs.append(v)
    logits = _logits(cfg, params, x[:, -1:])
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def _attn_block_chunk(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                      cache: Cache, layer: int, table_row: torch.Tensor,
                      chunk_pages: torch.Tensor, offset: int, kv_len: int,
                      *, window: int, lplan: Optional[LayerPlan]
                      ) -> torch.Tensor:
    """One attention block over a prompt chunk against the paged cache
    (``model.py:517``): the chunk's K/V are written into their pages
    first, then attention gathers the slot's pages (dead pages re-routed
    to NULL) and masks at absolute positions and ``kv_len``."""
    # Function-local: serving imports models at module load (as in the
    # reference, the page primitives live beside the allocator).
    from ..serving.kv_cache import (gather_pages, live_page_table,
                                    place_chunk_pages)
    b, c, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    layout = cfg.kv_cache_layout
    ap = p["attn"]
    q, k, v = _project_qkv(cfg, ap, x, p["ln1"], lplan)
    q = q.reshape(b, c, hq, hd)
    k = k.reshape(b, c, hkv, hd)
    v = v.reshape(b, c, hkv, hd)
    positions = offset + torch.arange(c, device=x.device)[None]
    q = L.apply_positional(cfg.rope, q, positions, cfg.rope_theta)
    k = L.apply_positional(cfg.rope, k, positions, cfg.rope_theta)
    kc, vc = cache["k"][layer], cache["v"][layer]
    place_chunk_pages(kc, k, chunk_pages, layout=layout)
    place_chunk_pages(vc, v, chunk_pages, layout=layout)
    row_live = live_page_table(table_row, kv_len, kc.shape[1])
    kseq = gather_pages(kc, row_live[None], layout=layout)
    vseq = gather_pages(vc, row_live[None], layout=layout)
    choice = lplan.attention if lplan is not None else None
    if choice is not None and choice.fused:
        o = L.fused_attention_chunk(q, kseq, vseq, offset, kv_len,
                                    causal=cfg.causal, window=window,
                                    block_kv=choice.kw["block_kv"])
    else:
        o = L.streaming_attention(q, kseq, vseq, causal=cfg.causal,
                                  q_offset=offset, window=window,
                                  kv_len=kv_len)
    x = x + o.reshape(b, c, hq * hd) @ ap["wo"]
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
    logits = _logits(cfg, params, x[:, last_idx:last_idx + 1])
    return logits.argmax(dim=-1).to(torch.int32), logits, cache


def _attn_block_decode(cfg: ModelConfig, p: Tree, x: torch.Tensor,
                       cache: Cache, layer: int, pos: torch.Tensor,
                       lengths: torch.Tensor, page_table: torch.Tensor, *,
                       window: int, lplan: Optional[LayerPlan]
                       ) -> torch.Tensor:
    """One attention block for one token per slot (paged branch of
    ``model.py:752``): append the token's K/V through the page table, then
    attend through the paged kernel or the gather-pages eager path."""
    from ..serving.kv_cache import (gather_pages, live_page_table,
                                    paged_append)
    b = x.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    layout = cfg.kv_cache_layout
    ap = p["attn"]
    q, k, v = _project_qkv(cfg, ap, x, p["ln1"], lplan)
    q = q.reshape(b, 1, hq, hd)
    k = k.reshape(b, 1, hkv, hd)
    v = v.reshape(b, 1, hkv, hd)
    q = L.apply_positional(cfg.rope, q, pos[:, None], cfg.rope_theta)
    k = L.apply_positional(cfg.rope, k, pos[:, None], cfg.rope_theta)
    kc, vc = cache["k"][layer], cache["v"][layer]
    paged_append(kc, page_table, pos, k, layout=layout)
    paged_append(vc, page_table, pos, v, layout=layout)
    choice = lplan.decode_attn if lplan is not None else None
    if choice is not None and choice.fused:
        o = L.fused_paged_attention(q, kc, vc, page_table, lengths + 1,
                                    window=window)
    else:
        tbl_live = live_page_table(page_table, lengths + 1, kc.shape[1])
        kd = gather_pages(kc, tbl_live, layout=layout)
        vd = gather_pages(vc, tbl_live, layout=layout)
        o = L.decode_attention(q, kd, vd, lengths + 1, window=window)
    x = x + o.reshape(b, 1, hq * hd) @ ap["wo"]
    return x + _ffn_block(cfg, p["mlp"], x, p["ln2"], lplan)


def decode_step(params: Tree, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Cache, cache_pos: torch.Tensor,
                lengths: torch.Tensor, *, page_table: torch.Tensor,
                plan: Optional[StreamPlan] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """One decoding step for every slot.

    tokens [B, 1] int32; cache the paged pools, updated in place;
    cache_pos [B] int32 write positions; lengths [B] int32 tokens already
    cached; page_table [B, max_pages] int32.  Returns (next_tokens [B, 1]
    int32, logits [B, 1, Vp], cache)."""
    b = tokens.shape[0]
    x = _embed(cfg, params, tokens, cache_pos[:, None])
    kv_extent = int(page_table.shape[1]) * int(cache["k"].shape[2])
    plan = resolve_plan(cfg, b, kv_len=kv_extent, plan=plan)
    for i, lp in enumerate(params["layers"]):
        x = _attn_block_decode(cfg, lp, x, cache, i, cache_pos, lengths,
                               page_table, window=_window(cfg, i),
                               lplan=_lplan(plan, cfg.layer_kind(i)))
    logits = _logits(cfg, params, x)
    return logits.argmax(dim=-1).to(torch.int32), logits, cache
