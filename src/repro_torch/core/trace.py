"""Model -> structured-op tracing (the Torch-MLIR/Linalg front-end analogue).

The paper enters at PyTorch and lowers to Linalg generic ops (Fig. 4).  Our
front-end is the ``ModelConfig``: ``trace_block`` emits the block's compute
graph as einsum-like ``LinalgOpSpec``s with named iteration dims, which the
tiling space (§5.1) tiles into dataflow kernels with itensor-typed ports.

Every assigned architecture family is covered:
  * dense / vlm / audio — (q|k|v|o) projections + attention + (Swi/Ge)GLU FFN
  * moe                 — router + top-k expert FFN (active-expert FLOPs)
  * hybrid (zamba2)     — Mamba2 chain (+ shared attention block every k)
  * ssm (rwkv6)         — time-mix (wkv recurrence) + channel-mix

Composite kernels (attention, ssm_scan, wkv) are deliberately kept as single
structured ops: their internals are the *kernel design* the paper delegates to
ADL/HLS (or, here, Pallas); StreamTensor's job is the inter-kernel dataflow.

A copy of the reference's ``repro.core.trace``, with the same names
and results.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ..configs.base import ModelConfig
from .tiling import PARALLEL, REDUCTION, LinalgOpSpec, LoopDim, OperandSpec


def _p(name: str, extent: int) -> LoopDim:
    return LoopDim(name, extent, PARALLEL)


def _r(name: str, extent: int) -> LoopDim:
    return LoopDim(name, extent, REDUCTION)


def _elementwise(name: str, op: str, t: int, d: int, src: Tuple[str, ...],
                 out: str, dtype: str, flops: float = 1.0,
                 dim_name: str = "d") -> LinalgOpSpec:
    loops = (_p("t", t), _p(dim_name, d))
    return LinalgOpSpec(
        name=name, op=op, loops=loops,
        inputs=tuple(OperandSpec(s, ("t", dim_name), dtype) for s in src),
        output=OperandSpec(out, ("t", dim_name), dtype),
        flops_per_point=flops)


def _matmul(name: str, t: int, n: int, k: int, src: str, weight: str,
            out: str, dtype: str, n_name: str = "n",
            k_name: str = "k") -> LinalgOpSpec:
    """out[t, n] = sum_k src[t, k] * W[k, n] — weight streamed from DRAM."""
    return LinalgOpSpec(
        name=name, op="matmul",
        loops=(_p("t", t), _p(n_name, n), _r(k_name, k)),
        inputs=(OperandSpec(src, ("t", k_name), dtype),
                OperandSpec(weight, (k_name, n_name), dtype, is_weight=True)),
        output=OperandSpec(out, ("t", n_name), dtype),
        flops_per_point=2.0)


def _norm(name: str, t: int, d: int, src: str, out: str,
          dtype: str) -> LinalgOpSpec:
    # Normalization is elementwise over (t, d) with an internal row reduction
    # (mean/var); the stream boundary is what matters to the dataflow level,
    # so flops_per_point folds the reduce+scale cost (~4 flops/elem).
    return _elementwise(name, "norm", t, d, (src,), out, dtype, flops=4.0)


# --------------------------------------------------------------------- #
# Family block tracers.  ``t`` = flattened tokens (batch * seq).
# --------------------------------------------------------------------- #

def _attention_ops(cfg: ModelConfig, t: int, s: int, pre: str, base: str,
                   dtype: str, sliding_window: int = 0) -> List[LinalgOpSpec]:
    """Attention sub-graph: q/k/v proj -> rope -> attention -> o proj.

    ``s`` is the key/value length attended per query (kv-cache length at
    decode, window size for local layers, seq length otherwise).
    """
    d, dq, dkv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    eff_s = min(s, sliding_window) if sliding_window else s
    ops = [
        _matmul(f"{base}.q_proj", t, dq, d, pre, f"{base}.wq", f"{base}.q",
                dtype, n_name="dq"),
        _matmul(f"{base}.k_proj", t, dkv, d, pre, f"{base}.wk", f"{base}.k",
                dtype, n_name="dkv"),
        _matmul(f"{base}.v_proj", t, dkv, d, pre, f"{base}.wv", f"{base}.v",
                dtype, n_name="dkv"),
    ]
    if cfg.rope != "none":
        ops.append(_elementwise(f"{base}.rope_q", "rope", t, dq,
                                (f"{base}.q",), f"{base}.qr", dtype,
                                flops=4.0, dim_name="dq"))
        ops.append(_elementwise(f"{base}.rope_k", "rope", t, dkv,
                                (f"{base}.k",), f"{base}.kr", dtype,
                                flops=4.0, dim_name="dkv"))
        q_in, k_in = f"{base}.qr", f"{base}.kr"
    else:
        q_in, k_in = f"{base}.q", f"{base}.k"
    # Composite attention kernel: QK^T + softmax + AV.  Iteration space
    # (t, s_red, dq); ~4 MAC-flops per point covers both matmuls, plus the
    # softmax folded into the constant.
    #
    # K/V streaming legality: the projections emit [t, dkv] while attention
    # consumes [s, dq].  Only when the extents agree (full self-attention,
    # no GQA head broadcast) can K/V stream straight into the attention
    # kernel; at decode (s = cache length) or under GQA expansion, K/V
    # round-trip the HBM KV-cache — a DMA boundary, represented by unwired
    # tensor ids.  This matches the physical design: the cache IS external
    # memory (paper §5.3.5 'dynamic tensor shape' hints size it).
    stream_kv = (dkv == dq) and (eff_s == t)
    if stream_kv:
        k_att, v_att = k_in, f"{base}.v"
    else:
        k_att, v_att = f"{base}.k_cache", f"{base}.v_cache"
    ops.append(LinalgOpSpec(
        name=f"{base}.attention", op="attention",
        loops=(_p("t", t), _p("dq", dq), _r("s", max(1, eff_s))),
        inputs=(OperandSpec(q_in, ("t", "dq"), dtype),
                OperandSpec(k_att, ("s", "dq"), dtype),
                OperandSpec(v_att, ("s", "dq"), dtype)),
        output=OperandSpec(f"{base}.attn", ("t", "dq"), dtype),
        flops_per_point=4.2))
    ops.append(_matmul(f"{base}.o_proj", t, d, dq, f"{base}.attn",
                       f"{base}.wo", f"{base}.attn_out", dtype,
                       k_name="dq", n_name="d"))
    return ops


def _ffn_ops(cfg: ModelConfig, t: int, pre: str, base: str, dtype: str,
             d_ff: Optional[int] = None) -> List[LinalgOpSpec]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.gated_ffn:
        return [
            _matmul(f"{base}.gate_proj", t, f, d, pre, f"{base}.wg",
                    f"{base}.gate", dtype, n_name="f"),
            _matmul(f"{base}.up_proj", t, f, d, pre, f"{base}.wu",
                    f"{base}.up", dtype, n_name="f"),
            _elementwise(f"{base}.act_mul", "act_mul", t, f,
                         (f"{base}.gate", f"{base}.up"), f"{base}.act",
                         dtype, flops=3.0, dim_name="f"),
            _matmul(f"{base}.down_proj", t, d, f, f"{base}.act",
                    f"{base}.wd", f"{base}.ffn_out", dtype,
                    k_name="f", n_name="d"),
        ]
    return [
        _matmul(f"{base}.up_proj", t, f, d, pre, f"{base}.wu",
                f"{base}.up", dtype, n_name="f"),
        _elementwise(f"{base}.act", "act", t, f, (f"{base}.up",),
                     f"{base}.act", dtype, flops=2.0, dim_name="f"),
        _matmul(f"{base}.down_proj", t, d, f, f"{base}.act", f"{base}.wd",
                f"{base}.ffn_out", dtype, k_name="f", n_name="d"),
    ]


def _moe_ops(cfg: ModelConfig, t: int, pre: str, base: str,
             dtype: str) -> List[LinalgOpSpec]:
    d, f, e, k = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.top_k
    ops = [
        _matmul(f"{base}.router", t, e, d, pre, f"{base}.wr",
                f"{base}.route", dtype, n_name="e"),
        _elementwise(f"{base}.topk", "topk", t, e, (f"{base}.route",),
                     f"{base}.gates", dtype, flops=2.0, dim_name="e"),
    ]
    # Composite expert kernel: dispatch + top-k active expert GLU FFNs +
    # weighted combine.  Loops cover the full expert axis ``e`` (the weight
    # table's extent); flops_per_point is scaled by k/e so work counts only
    # the *active* experts (paper: T static; top-k fixes tokens per expert).
    glu_flops = (3 if cfg.gated_ffn else 2) * 2.0 * (k / e)
    ops.append(LinalgOpSpec(
        name=f"{base}.experts", op="moe_experts",
        loops=(_p("t", t), _p("d", d), _r("f", f), _r("e", e)),
        inputs=(OperandSpec(pre, ("t", "d"), dtype),
                OperandSpec(f"{base}.gates", ("t", "e"), dtype),
                OperandSpec(f"{base}.we", ("e", "f", "d"), dtype,
                            is_weight=True)),
        output=OperandSpec(f"{base}.ffn_out", ("t", "d"), dtype),
        flops_per_point=glu_flops))
    return ops


def _mamba_ops(cfg: ModelConfig, t: int, pre: str, base: str,
               dtype: str) -> List[LinalgOpSpec]:
    """Mamba2 chain, projections decomposed so every stream edge is typed
    (the fused in_proj would need ``itensor_chunk``; separate x/z/BCdt
    projections are the dataflow-native formulation)."""
    d, di = cfg.d_model, cfg.d_inner
    h, n = cfg.ssm_heads, cfg.ssm_state
    bcdt = 2 * h * n + h                  # B, C, dt widths concatenated
    # Real scan flops per (t, di) point ~ 6*n (dA, dB*x, C*h per state elem);
    # the bcdt reduction loop has extent 2hn+h, so scale per-point flops.
    scan_fpp = 6.0 * n / bcdt
    ops = [
        _matmul(f"{base}.x_proj", t, di, d, pre, f"{base}.wx",
                f"{base}.x", dtype, n_name="di"),
        _matmul(f"{base}.z_proj", t, di, d, pre, f"{base}.wz",
                f"{base}.z", dtype, n_name="di"),
        _matmul(f"{base}.bcdt_proj", t, bcdt, d, pre, f"{base}.wbcdt",
                f"{base}.bcdt", dtype, n_name="bcn"),
        _elementwise(f"{base}.conv", "conv1d", t, di, (f"{base}.x",),
                     f"{base}.xconv", dtype, flops=2.0 * cfg.conv_width,
                     dim_name="di"),
        # Composite chunked state-space scan: per head, state [n x hd]
        # updated per token (dA/dBx/Ch work folded into scan_fpp).
        LinalgOpSpec(
            name=f"{base}.ssm_scan", op="ssm_scan",
            loops=(_p("t", t), _p("di", di), _r("bcn", bcdt)),
            inputs=(OperandSpec(f"{base}.xconv", ("t", "di"), dtype),
                    OperandSpec(f"{base}.bcdt", ("t", "bcn"), dtype)),
            output=OperandSpec(f"{base}.ssm", ("t", "di"), dtype),
            flops_per_point=scan_fpp),
        _elementwise(f"{base}.gate", "act_mul", t, di,
                     (f"{base}.ssm", f"{base}.z"), f"{base}.gated",
                     dtype, flops=3.0, dim_name="di"),
        _matmul(f"{base}.out_proj", t, d, di, f"{base}.gated",
                f"{base}.wout", f"{base}.ffn_out", dtype, k_name="di",
                n_name="d"),
    ]
    return ops


def _rwkv_ops(cfg: ModelConfig, t: int, pre: str, base: str,
              dtype: str) -> List[LinalgOpSpec]:
    """RWKV6 time-mix + channel-mix, r/k/v/g/w projections decomposed so
    every stream edge is typed (no itensor_chunk needed)."""
    d, f = cfg.d_model, cfg.d_ff
    ops = [
        _matmul(f"{base}.{nm}_proj", t, d, d, pre, f"{base}.w{nm}",
                f"{base}.{nm}", dtype, n_name="dm")
        for nm in ("r", "k", "v", "w")
    ]
    ops += [
        _matmul(f"{base}.g_proj", t, d, d, pre, f"{base}.wgm",
                f"{base}.g", dtype, n_name="dm"),
        # wkv6 recurrence: per head, state [hd x hd] with data-dependent
        # decay; iteration (t, d) with hd-deep inner reduction.
        LinalgOpSpec(
            name=f"{base}.wkv", op="wkv6",
            loops=(_p("t", t), _p("d", d), _r("hd", cfg.rwkv_head_dim)),
            inputs=(OperandSpec(f"{base}.r", ("t", "d"), dtype),
                    OperandSpec(f"{base}.k", ("t", "d"), dtype),
                    OperandSpec(f"{base}.v", ("t", "d"), dtype),
                    OperandSpec(f"{base}.w", ("t", "d"), dtype)),
            output=OperandSpec(f"{base}.wkv_raw", ("t", "d"), dtype),
            flops_per_point=8.0),
        _elementwise(f"{base}.out_gate", "act_mul", t, d,
                     (f"{base}.wkv_raw", f"{base}.g"), f"{base}.wkv_out",
                     dtype, flops=3.0),
        _matmul(f"{base}.out_proj", t, d, d, f"{base}.wkv_out",
                f"{base}.wo", f"{base}.attn_out", dtype, k_name="dk",
                n_name="d"),
        # Channel mix.
        _norm(f"{base}.ln2", t, d, f"{base}.attn_out", f"{base}.cm_in",
              dtype),
        _matmul(f"{base}.cm_k", t, f, d, f"{base}.cm_in", f"{base}.wk",
                f"{base}.cm_kx", dtype, n_name="f"),
        _elementwise(f"{base}.cm_act", "act", t, f, (f"{base}.cm_kx",),
                     f"{base}.cm_act_o", dtype, flops=2.0, dim_name="f"),
        _matmul(f"{base}.cm_v", t, d, f, f"{base}.cm_act_o", f"{base}.wv",
                f"{base}.ffn_out", dtype, k_name="f", n_name="d"),
    ]
    return ops


# --------------------------------------------------------------------- #
# Public entry points
# --------------------------------------------------------------------- #

def trace_block(cfg: ModelConfig, *, tokens: int, kv_len: Optional[int] = None,
                layer_index: int = 0) -> List[LinalgOpSpec]:
    """Trace one transformer block into structured ops.

    Args:
        cfg: architecture config.
        tokens: flattened query tokens (batch * seq).
        kv_len: keys/values attended per query (defaults to ``tokens``);
            pass the cache length for decode shapes.
        layer_index: which layer of the pattern (local vs global, shared-attn
            boundary, ...).
    """
    dtype = cfg.dtype
    kv = kv_len if kv_len is not None else tokens
    kind = cfg.layer_kind(layer_index)
    base = f"L{layer_index}"
    ops: List[LinalgOpSpec] = []

    if kind == "rwkv":
        ops.append(_norm(f"{base}.ln1", tokens, cfg.d_model,
                         "x_in", f"{base}.pre", dtype))
        ops += _rwkv_ops(cfg, tokens, f"{base}.pre", base, dtype)
        ops.append(_elementwise(f"{base}.resid", "add", tokens, cfg.d_model,
                                ("x_in", f"{base}.ffn_out"), "x_out", dtype))
        return ops

    if kind.startswith("mamba"):
        ops.append(_norm(f"{base}.ln1", tokens, cfg.d_model, "x_in",
                         f"{base}.pre", dtype))
        ops += _mamba_ops(cfg, tokens, f"{base}.pre", base, dtype)
        out_src = f"{base}.ffn_out"
        if kind == "mamba+shared_attn":
            sa = f"{base}.shared"
            ops.append(_norm(f"{sa}.ln", tokens, cfg.d_model, out_src,
                             f"{sa}.pre", dtype))
            ops += _attention_ops(cfg, tokens, kv, f"{sa}.pre", sa, dtype)
            ops += _ffn_ops(cfg, tokens, f"{sa}.attn_out", sa + ".mlp", dtype)
            out_src = f"{sa}.mlp.ffn_out"
        ops.append(_elementwise(f"{base}.resid", "add", tokens, cfg.d_model,
                                ("x_in", out_src), "x_out", dtype))
        return ops

    # Attention families (dense / vlm / audio / moe / local / global).
    window = cfg.sliding_window if kind == "local_attn" else 0
    ops.append(_norm(f"{base}.ln1", tokens, cfg.d_model, "x_in",
                     f"{base}.pre1", dtype))
    ops += _attention_ops(cfg, tokens, kv, f"{base}.pre1", base, dtype,
                          sliding_window=window)
    ops.append(_elementwise(f"{base}.resid1", "add", tokens, cfg.d_model,
                            ("x_in", f"{base}.attn_out"), f"{base}.h1",
                            dtype))
    ops.append(_norm(f"{base}.ln2", tokens, cfg.d_model, f"{base}.h1",
                     f"{base}.pre2", dtype))
    if cfg.is_moe:
        ops += _moe_ops(cfg, tokens, f"{base}.pre2", base + ".moe", dtype)
        ffn_out = f"{base}.moe.ffn_out"
    else:
        ops += _ffn_ops(cfg, tokens, f"{base}.pre2", base + ".mlp", dtype)
        ffn_out = f"{base}.mlp.ffn_out"
    ops.append(_elementwise(f"{base}.resid2", "add", tokens, cfg.d_model,
                            (f"{base}.h1", ffn_out), "x_out", dtype))
    return ops


def trace_lm_head(cfg: ModelConfig, tokens: int) -> List[LinalgOpSpec]:
    """Final norm + LM head projection (streamed over vocab tiles)."""
    dtype = cfg.dtype
    return [
        _norm("final.ln", tokens, cfg.d_model, "x_in", "final.pre", dtype),
        _matmul("final.lm_head", tokens, cfg.vocab_size, cfg.d_model,
                "final.pre", "final.wemb", "logits", dtype, n_name="v"),
    ]


def block_flops(cfg: ModelConfig, tokens: int,
                kv_len: Optional[int] = None) -> float:
    return sum(op.work_flops
               for op in trace_block(cfg, tokens=tokens, kv_len=kv_len))
