#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, one JSON line each (numbers measured in this run, on this card):

1. device   — the card's name and power limit (nvidia-smi), then the build
              of every CUDA kernel with nvcc for sm_90a from ``csrc/``;
2. kernel   — each kernel against its plain PyTorch version at the main
              paths' shapes (llama3-8b and gpt2: the projections, FFNs and
              their int8 twins at a prefill chunk, decode and a verify
              dispatch of 4 slots x 5 rows, gpt2's also at whole-prompt
              lengths; the o-projection, the LM head over the padded
              vocabulary and gpt2's LayerNorm rows; chunk, decode and
              verify attention over full-precision, int8 and fp8 pools;
              the training path's static attention and streamed
              cross-entropy at a training step's tokens: gpt2 8 x 1024,
              llama3-8b 2 x 2048 with GQA; granite-moe-3b's MoE experts
              (K12), router product, ln2 rows, projections and attention
              at decode, verify, a prefill chunk and a whole prompt, and
              granite-moe-1b's experts, projections, attention and loss
              at a training step's 2 x 2048 tokens),
              in bfloat16 and float32: max error against the stated
              tolerance, kernel / plain / library times (CUDA events, L2
              flushed between launches) and the card's bound; every row
              of each verify kernel equals its decode kernel at that
              row's length, bit for bit; K12's bound counts the experts
              and (token, expert) pairs its gates keep, the dense-gather
              bound beside it;
3. row_invariance — every call on the kernel plan's path gives rows 0..3
              the same bits at 4 rows (decode) as at 8, 12 and 20 (verify
              windows of 2, 3 and 5): the projection and FFN kernels and
              their int8 twins, the o-projection, the LM head and the
              norms, and granite-moe-3b's MoE stage at 1, 8, 12, 20 and
              64 rows (required); the eager plan's PyTorch calls at those
              shapes are reported beside them;
4. fused_vs_eager, gpt2_fused_vs_eager, granite_fused_vs_eager —
              llama3-8b, gpt2 (jittered) and granite-moe-3b at full width
              cut to 4 layers, float32: a mixed burst through
              ``ServingEngine`` with the kernel plan and with the eager
              plan must give the same greedy tokens (gpt2 and granite:
              with chunked and with whole-prompt admission, the kernel
              plan launching exactly its path's kernels);
5. spec_fused_vs_eager — the three models at 4 layers, float32, on the
              speculative burst (8 prompts sharing a 512-token prefix, two
              repeated verbatim, 32 new tokens each): the plain engine (no
              prefix cache), the default engine (prefix cache on), the
              speculative engine (draft_len 4) with the kernel plan and
              with the eager plan must all give the same greedy tokens,
              the speculative one launching exactly its path's kernels;
6. quant_fused_vs_eager — the three models at 4 layers, float32: under every
              quant mode (kv_int8, kv_fp8, w8, w8_kv8) the kernel plan must
              give the eager plan's tokens (weight modes: on the eager w8
              reference weights), and under kv_int8 the speculative engine
              the plain engine's;
7. accuracy — the three models at 4 layers, float32 (gpt2 jittered): the
              teacher-forced gate of every quant mode against the
              unquantized engine (max logit error, token equality; the
              errors must be finite);
8. serve, gpt2_serve, granite_serve, spec_serve, quant_serve,
              quant_spec_serve — llama3-8b, gpt2 and granite-moe-3b at
              full width and depth, bfloat16, random weights
              drawn on the card from a seed (gpt2 jittered): a mixed burst
              of 8 prompts (37..1000 tokens; gpt2 up to 992 in its
              1024-position context; 32 new tokens each) through the
              paged, chunked-prefill engine (gpt2 and granite also
              whole-prompt); the
              speculative burst through the speculative engine against
              the plain engine, token for token (required: the path is
              row-invariant); then both under w8_kv8 (speculative token
              equality reported only: rejected draft rows leave their
              pages' scale growth behind, as in the reference).  Each
              burst must launch exactly its path's kernels (the quantized
              twins, and never K1, K2 or K8, under KV quantization) and
              complete every request; the first prompt served alone must
              repeat its burst tokens;
9. train_fused_vs_eager — the three models at full width cut to 4 layers,
              float32, B = 2, S = 256: the kernel plan's ``forward_train``
              loss against the eager plan's (relative 1e-5) and every
              gradient leaf (1e-4), 3 ``make_train_step`` steps on each plan
              (losses within 1e-4), and the kernel plan's launches per step
              equal to the plan's (the forward, the re-run of each layer
              under remat, the loss once);
10. train   — ``Trainer.run()`` on the kernel plan, bfloat16 compute over
              float32 master weights and AdamW state: gpt2 at full width
              and depth (B = 8, S = 1024) for 6 steps with a checkpoint
              every 3, then a second trainer resuming from step 3 and
              replaying steps 4-6 (losses equal at relative 1e-3, bit
              equality reported); llama3-8b at full width cut to 2 layers
              (B = 2, S = 2048; the full depth does not fit one card) for
              3 steps and a timed restore; granite-moe-1b at full width
              and depth (B = 2, S = 2048, lr 3e-5) for 3 steps, no
              checkpoint.  Losses finite and falling,
              launches the plan's; step time, tokens/s, peak memory and
              checkpoint seconds reported;
11. kernels — one line listing every kernel, once per model and path
              (serving or training) that runs it, with its check results
              and that path's own launch count.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository beside this script, it exits non-zero and prints
no result.  Full results and the nvcc resource report also go to
``--out`` (default ``build/chip_smoke/``): ``chip_smoke.json``,
``ptxas.txt``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core bf16
              "float32": 67e12}           # float32 outside the tensor cores
# Max |kernel - plain| over max |plain|.  float32: the two sum in different
# orders (up to 14336-long dot products); bfloat16: on top of that an
# intermediate rounded to bf16 (normalised x, h, p) may land one bf16 ulp
# apart, and outputs are bf16.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TPU_KERNELS = {
    "rmsnorm_matmul": "src/repro/kernels/rmsnorm_matmul.py:28",
    "streamed_ffn": "src/repro/kernels/streamed_ffn.py:57",
    "flash_attention": "src/repro/kernels/flash_attention.py:86",
    "paged_attention": "src/repro/kernels/paged_attention.py:61",
    "block_matmul": "src/repro/kernels/block_matmul.py:29",
    "streamed_mlp": "src/repro/kernels/streamed_ffn.py:181",
    "flash_attention_static": "src/repro/kernels/flash_attention.py:33",
    "paged_verify_attention": "src/repro/kernels/paged_attention.py:169",
    "paged_attention_q": "src/repro/kernels/paged_attention.py:113",
    "paged_verify_attention_q": "src/repro/kernels/paged_attention.py:232",
    "flash_attention_q": "src/repro/kernels/flash_attention.py:151",
    "rmsnorm_matmul_w8": "src/repro/kernels/rmsnorm_matmul.py:38",
    "streamed_ffn_w8": "src/repro/kernels/streamed_ffn.py:81",
    "streamed_mlp_w8": "src/repro/kernels/streamed_ffn.py:205",
    # Not a TPU kernel: the eager LayerNorm the reference leaves to XLA,
    # made a kernel so that its rows do not depend on the row count.
    "row_norm": "src/repro/models/layers.py:195",
    "streamed_xent": "src/repro/kernels/streamed_xent.py:35",
    "moe_experts": "src/repro/kernels/moe_experts.py:35",
    # The row-norm helper's RMSNorm mode: the eager RMSNorm the reference
    # leaves to XLA in front of the MoE router and experts.
    "rms_norm_rows": "src/repro/models/layers.py:187",
}
HELPERS = {"row_norm", "rms_norm_rows"}
_CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "rmsnorm_matmul": _CSRC + "rmsnorm_matmul.cu",
    "streamed_ffn": _CSRC + "streamed_ffn.cu",
    "flash_attention": _CSRC + "flash_attention.cu",
    "paged_attention": _CSRC + "paged_attention.cu",
    "block_matmul": _CSRC + "block_matmul.cu",
    "streamed_mlp": _CSRC + "streamed_ffn.cu",
    "flash_attention_static": _CSRC + "flash_attention.cu",
    "paged_verify_attention": _CSRC + "paged_attention.cu",
    "paged_attention_q": _CSRC + "paged_attention.cu",
    "paged_verify_attention_q": _CSRC + "paged_attention.cu",
    "flash_attention_q": _CSRC + "flash_attention.cu",
    "rmsnorm_matmul_w8": _CSRC + "rmsnorm_matmul.cu",
    "streamed_ffn_w8": _CSRC + "streamed_ffn.cu",
    "streamed_mlp_w8": _CSRC + "streamed_ffn.cu",
    "row_norm": _CSRC + "row_norm.cu",
    "streamed_xent": _CSRC + "streamed_xent.cu",
    "moe_experts": _CSRC + "moe_experts.cu",
    "rms_norm_rows": _CSRC + "row_norm.cu",
}
# The kernels each serving path must launch; every other count must be 0.
# On the kernel plan the o-projection runs through block_matmul, llama3's
# final norm and LM head through one rmsnorm_matmul, gpt2's LM head through
# block_matmul and its LayerNorms through row_norm (row invariance).
LLAMA_PATH = {"rmsnorm_matmul", "streamed_ffn", "flash_attention",
              "paged_attention", "block_matmul"}
GPT2_PATHS = {
    "chunked": {"block_matmul", "streamed_mlp", "flash_attention",
                "paged_attention", "row_norm"},
    "whole_prompt": {"block_matmul", "streamed_mlp",
                     "flash_attention_static", "paged_attention",
                     "row_norm"},
}
# granite-moe: llama3's attention kernels (at head dim 64), its final norm
# and LM head through rmsnorm_matmul; ln2 through the row-norm kernel's
# RMSNorm mode, the router product through block_matmul (besides the
# o-projection), the experts through moe_experts.
GRANITE = "granite-moe-3b-a800m"
GRANITE_TRAIN = "granite-moe-1b-a400m"
_GRANITE = {"rmsnorm_matmul", "block_matmul", "rms_norm_rows", "moe_experts"}
GRANITE_PATHS = {
    "chunked": _GRANITE | {"flash_attention", "paged_attention"},
    "whole_prompt": _GRANITE | {"flash_attention_static", "paged_attention"},
}
SERVE_PATHS = {"llama3-8b": {"chunked": LLAMA_PATH}, "gpt2": GPT2_PATHS,
               GRANITE: GRANITE_PATHS}
# The speculative engine verifies every decode: K8, never K1.
SPEC_PATHS = {
    "llama3-8b": {"rmsnorm_matmul", "streamed_ffn", "flash_attention",
                  "paged_verify_attention", "block_matmul"},
    "gpt2": {"block_matmul", "streamed_mlp", "flash_attention",
             "paged_verify_attention", "row_norm"},
    GRANITE: _GRANITE | {"flash_attention", "paged_verify_attention"},
}
# Under w8_kv8 the attention kernels read code pools (K9, never K1, K2 or
# K8) and the w8 stages run their int8 twins (K10); the o-projection and
# the LM head stay at full precision, as does gpt2's qkv block_matmul.
# Whole-prompt admission attends over the fresh full-precision K/V (K7)
# before placing it into the pools as codes.
QUANT_MODE = "w8_kv8"
QUANT_PATHS = {
    ("llama3-8b", "chunked"): {"rmsnorm_matmul_w8", "streamed_ffn_w8",
                               "flash_attention_q", "paged_attention_q",
                               "block_matmul", "rmsnorm_matmul"},
    ("gpt2", "chunked"): {"block_matmul", "streamed_mlp_w8",
                          "flash_attention_q", "paged_attention_q",
                          "row_norm"},
    ("gpt2", "whole_prompt"): {"block_matmul", "streamed_mlp_w8",
                               "flash_attention_static",
                               "paged_attention_q", "row_norm"},
    ("llama3-8b", "speculative"): {"rmsnorm_matmul_w8", "streamed_ffn_w8",
                                   "flash_attention_q",
                                   "paged_verify_attention_q",
                                   "block_matmul", "rmsnorm_matmul"},
    ("gpt2", "speculative"): {"block_matmul", "streamed_mlp_w8",
                              "flash_attention_q",
                              "paged_verify_attention_q", "row_norm"},
    # granite: qkv through the int8 twin, the experts at full precision
    # (K12 has no int8 twin), the LM head rmsnorm_matmul as llama3's.
    (GRANITE, "chunked"): _GRANITE | {"rmsnorm_matmul_w8",
                                      "flash_attention_q",
                                      "paged_attention_q"},
    (GRANITE, "whole_prompt"): _GRANITE | {"rmsnorm_matmul_w8",
                                           "flash_attention_static",
                                           "paged_attention_q"},
    (GRANITE, "speculative"): _GRANITE | {"rmsnorm_matmul_w8",
                                          "flash_attention_q",
                                          "paged_verify_attention_q"},
}
# The training path on the kernel plan: each layer's forward launches, the
# static flash kernel for attention; under remat the backward runs every
# layer's forward again (the eager backward itself launches nothing); the
# loss kernel once per step.  The o-projection, the norms outside the
# kernels and every backward are PyTorch ops.
TRAIN_LAYER_LAUNCHES = {
    "llama3-8b": {"rmsnorm_matmul": 3, "streamed_ffn": 1,
                  "flash_attention_static": 1},
    "gpt2": {"block_matmul": 3, "streamed_mlp": 1,
             "flash_attention_static": 1},
    GRANITE_TRAIN: {"rmsnorm_matmul": 3, "moe_experts": 1,
                    "flash_attention_static": 1},
}
TRAIN_LAYER_LAUNCHES[GRANITE] = TRAIN_LAYER_LAUNCHES[GRANITE_TRAIN]
# Training shapes: gpt2 at GPT-2's 1024-token context (8 sequences),
# llama3-8b and granite-moe-1b-a400m at 2 x 2048.
TRAIN_SHAPES = {"gpt2": (8, 1024), "llama3-8b": (2, 2048),
                GRANITE_TRAIN: (2, 2048)}
CODES = ("int8", "fp8")
# A verify dispatch: 4 slots x a 5-row window (draft_len 4); the window
# ladder's other rungs give 2 and 3 rows.
SLOTS, WINDOW = 4, 5
SPEC_T = SLOTS * WINDOW


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def train_step_launches(model: str, layers: int, remat: bool = True):
    """Each kernel's launches in one training step on the kernel plan."""
    runs = 2 if remat else 1
    out = {k: runs * n * layers
           for k, n in TRAIN_LAYER_LAUNCHES[model].items()}
    out["streamed_xent"] = 1
    return out


# --------------------------------------------------------------------- #
# Timing and bounds
# --------------------------------------------------------------------- #

class Timer:
    """Median of per-launch CUDA-event times, with a buffer larger than the
    50 MB L2 rewritten before each launch (the model finds weights cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 10) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            events.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------- #
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------- #

def _randn(torch, gen, dtype, dev):
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype)
    return randn


def _code_dtype(torch, code):
    """None (full precision), or the torch dtype of "int8" / "fp8" codes."""
    return {None: None, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[code]


def _encode(torch, x, code, page_axis):
    """(codes, scales) of ``x`` [P, ps, H, D] (page_axis 0) or [H, S, D]
    cut into 16-position pages: one float32 scale per (page, head), each
    page's amax over qmax, as the pools hold them."""
    from repro_torch.serving.kv_cache import kv_quant_qmax, quantize_kv
    dt = _code_dtype(torch, code)
    if page_axis == 0:
        s = x.float().abs().amax(dim=(1, 3)) / kv_quant_qmax(dt)   # [P, H]
        return quantize_kv(x, s[:, None, :, None], dt), s
    h, n, d = x.shape
    pages = x.reshape(h, n // 16, 16, d)
    s = pages.float().abs().amax(dim=(2, 3)) / kv_quant_qmax(dt)  # [H, n/16]
    pos = s.repeat_interleave(16, dim=1).contiguous()              # [H, S]
    return quantize_kv(x, pos[..., None], dt), pos


def _flash_case(torch, K, ref, randn, isz, name, hq, hkv, hd, sq, skv,
                q_off, dev, code=None):
    """A causal flash call and its SDPA yardstick: the offset branch over a
    gathered extent (``q_off`` set, kv_len = q_off + sq), or the static
    branch over a whole prompt (``q_off`` None, sq == skv); with ``code``
    the offset branch over int8 / fp8 codes with per-position scales (no
    single PyTorch call reads codes: no library yardstick)."""
    kv_len = skv if q_off is None else q_off + sq
    q = randn(hq, sq, hd)
    k = randn(hkv, skv, hd)
    v = randn(hkv, skv, hd)
    qpos = (q_off or 0) + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(skv, device=dev)[None, :]
    mask = (kpos <= qpos) & (kpos < kv_len)
    live_pairs = int(mask.sum()) * hq
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = hq // hkv
    kv_bytes = 2 * hkv * kv_len * hd * isz
    if code is not None:
        (k, ks), (v, vs) = (_encode(torch, t.float(), code, 1) for t in (k, v))
        kernel = lambda: K.flash_attention_2d_q(
            q, k, v, k_scale=ks, v_scale=vs, q_offset=q_off, kv_len=kv_len,
            kv_group=g)
        plain = lambda: ref.flash_attention_offset(
            q, k, v, q_offset=q_off, kv_len=kv_len, kv_group=g, k_scale=ks,
            v_scale=vs)
        library = None
        kv_bytes = 2 * hkv * kv_len * (hd + 4)     # codes + f32 scales
        shape = (f"Hq={hq},Hkv={hkv},D={hd},Sq={sq},Skv={skv},"
                 f"q_offset={q_off},kv_len={kv_len},codes={code}")
    elif q_off is None:
        kernel = lambda: K.flash_attention_2d(q, k, v, kv_group=g)
        plain = lambda: ref.flash_attention_static(q, k, v, kv_len=kv_len,
                                                   kv_group=g)
        library = lambda: sdpa(q[None], k[None], v[None], is_causal=True,
                               enable_gqa=True)
        shape = f"Hq={hq},Hkv={hkv},D={hd},S={sq}"
    else:
        kernel = lambda: K.flash_attention_2d(q, k, v, q_offset=q_off,
                                              kv_len=kv_len, kv_group=g)
        plain = lambda: ref.flash_attention_offset(q, k, v, q_offset=q_off,
                                                   kv_len=kv_len, kv_group=g)
        library = lambda: sdpa(q[None], k[None], v[None], attn_mask=mask,
                               enable_gqa=True)
        shape = (f"Hq={hq},Hkv={hkv},D={hd},Sq={sq},Skv={skv},"
                 f"q_offset={q_off},kv_len={kv_len}")
    return dict(name=name, head_dim=hd, shape=shape, kernel=kernel,
                plain=plain, library=library, cublas=None,
                nbytes=2 * hq * sq * hd * isz + kv_bytes,
                flops=4 * hd * live_pairs)


def _paged_pools(torch, randn, gen, b, maxp, hkv, hd, code, dev):
    """K/V pools of 1 + b * maxp 16-token pages (codes and [P, Hkv] scales
    with ``code``), a shuffled page table, and the pool's bytes per KV
    element (codes + amortized scales, or the dtype's)."""
    ps, pool_pages = 16, 1 + b * maxp
    kp = randn(pool_pages, ps, hkv, hd)
    vp = randn(pool_pages, ps, hkv, hd)
    scales = {}
    if code is not None:
        (kp, ks), (vp, vs) = (_encode(torch, t.float(), code, 0)
                              for t in (kp, vp))
        scales = dict(k_scale=ks, v_scale=vs)
    perm = torch.randperm(pool_pages - 1, generator=gen, device=dev) + 1
    table = perm[:b * maxp].reshape(b, maxp).to(torch.int32).contiguous()
    per_elem = (1 + 4 / (ps * hd)) if code is not None else None
    return kp, vp, scales, table, per_elem


def _paged_case(torch, K, ref, randn, isz, gen, hq, hkv, hd, maxp, dev,
                code=None):
    """Paged decode: 4 slots, ``maxp`` 16-token pages of capacity each;
    with ``code`` over int8 / fp8 code pools (K9a)."""
    b, ps = 4, 16
    kp, vp, sc, table, per_elem = _paged_pools(torch, randn, gen, b, maxp,
                                               hkv, hd, code, dev)
    lens = [1000, 517, 37, 0]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = randn(b, 1, hq, hd)
    if code is None:
        kernel = lambda: K.paged_decode_attention(qd, kp, vp, table, lengths)
    else:
        kernel = lambda: K.paged_decode_attention_q(qd, kp, vp, table,
                                                    lengths, **sc)
    return dict(
        name="paged_attention" if code is None else "paged_attention_q",
        head_dim=hd,
        shape=(f"B={b},Hq={hq},Hkv={hkv},D={hd},ps={ps},lengths={lens}"
               + (f",codes={code}" if code else "")),
        kernel=kernel,
        plain=lambda: ref.paged_decode_attention(qd, kp, vp, table, lengths,
                                                 **sc),
        library=None, cublas=None,
        nbytes=2 * b * hq * hd * isz
        + 2 * sum(lens) * hkv * hd * (per_elem or isz) + (b * maxp + b) * 4,
        flops=4 * hd * hq * sum(lens))


def _verify_case(torch, K, ref, randn, isz, gen, hq, hkv, hd, maxp, dev,
                 code=None):
    """Speculative verify: 4 slots, a 5-row window at offsets 1000, 517,
    37 and 0, ``maxp`` 16-token pages of capacity each (with ``code`` over
    code pools, K9b).  The bytes are the live pages' K/V (through each
    slot's deepest row) plus q and out, as the decode kernel's; the
    operations count each row's own extent."""
    b, ps, w = SLOTS, 16, WINDOW
    kp, vp, sc, table, per_elem = _paged_pools(torch, randn, gen, b, maxp,
                                               hkv, hd, code, dev)
    offs = [1000, 517, 37, 0]
    q_off = torch.tensor(offs, dtype=torch.int32, device=dev)
    qv = randn(b, w, hq, hd)
    rows = sum(o + i + 1 for o in offs for i in range(w))
    if code is None:
        verify, decode = K.paged_verify_attention, K.paged_decode_attention
    else:
        verify, decode = K.paged_verify_attention_q, K.paged_decode_attention_q
    return dict(
        name=("paged_verify_attention" if code is None
              else "paged_verify_attention_q"), head_dim=hd,
        shape=(f"B={b},W={w},Hq={hq},Hkv={hkv},D={hd},ps={ps},"
               f"q_off={offs}" + (f",codes={code}" if code else "")),
        kernel=lambda: verify(qv, kp, vp, table, q_off, **sc),
        plain=lambda: ref.paged_verify_attention(qv, kp, vp, table, q_off,
                                                 **sc),
        library=None, cublas=None,
        nbytes=2 * b * w * hq * hd * isz
        + 2 * sum(o + w for o in offs) * hkv * hd * (per_elem or isz)
        + (b * maxp + b) * 4,
        flops=4 * hd * hq * rows,
        rows_vs_decode=lambda out: [
            bool(torch.equal(out[:, i:i + 1], decode(
                qv[:, i:i + 1].contiguous(), kp, vp, table, q_off + i + 1,
                **sc)))
            for i in range(w)])


def _attention_cases(torch, K, ref, randn, isz, gen, hq, hkv, hd, maxp,
                     flash_skv, dev):
    """The chunk, decode and verify attention calls at one model's widths,
    over full-precision pools and over int8 and fp8 codes (K2/K1/K8 and
    their twins K9c/K9a/K9b): a 128-token chunk at offset 896 over a
    ``flash_skv``-position gathered extent; 4 slots of lengths 1000, 517,
    37, 0; a 5-row verify window at those offsets."""
    cases = []
    for code in (None,) + CODES:
        cases.append(_flash_case(
            torch, K, ref, randn, isz,
            "flash_attention" if code is None else "flash_attention_q",
            hq, hkv, hd, 128, flash_skv, 896, dev, code))
        cases.append(_paged_case(torch, K, ref, randn, isz, gen, hq, hkv,
                                 hd, maxp, dev, code))
        vc = _verify_case(torch, K, ref, randn, isz, gen, hq, hkv, hd, maxp,
                          dev, code)
        cases.append(dict(vc, path="speculative"))
    return cases


def _w8(torch, *ws):
    """(codes, scales) of each weight, quantized per output channel."""
    from repro_torch.models.layers import quantize_channelwise
    return [quantize_channelwise(w) for w in ws]


def kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """llama3-8b's kernel calls: name, shape label, kernel / plain /
    library call (one PyTorch call computing the same function, or None),
    a cuBLAS yardstick (the matmuls alone, on pre-normalised x and, for
    the int8 twins, dequantized weights; or None), and the bytes and
    operations the call needs.  The projections and the FFN at a prefill
    chunk (T = 128), a decode step (4) and a verify dispatch (20), full
    precision and int8; the o-projection (block_matmul) and the final norm
    with the LM head over the padded vocabulary (rmsnorm_matmul) at one
    prefill read-out row, decode and verify; the attention calls."""
    from repro_torch.models.params import padded_vocab
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    cases = []
    d, f = 4096, 14336
    for t in (128, 4, SPEC_T):
        path = "speculative" if t == SPEC_T else None
        x = randn(t, d)
        s = randn(d, scale=0.1)
        xn = ref.rms_rows(x, s, 1e-6)
        for n in (4096, 1024):
            w = randn(d, n, scale=1 / math.sqrt(d))
            cases.append(dict(
                name="rmsnorm_matmul", shape=f"T={t},D={d},N={n}",
                kernel=lambda x=x, s=s, w=w: K.rmsnorm_matmul(x, s, w),
                plain=lambda x=x, s=s, w=w: ref.rmsnorm_matmul(x, s, w),
                library=None,
                cublas=lambda xn=xn, w=w: torch.matmul(xn, w),
                nbytes=(t * d + d + d * n + t * n) * isz,
                flops=2 * t * d * n, path=path))
            (c, ws), = _w8(torch, w)
            wq = (c.float() * ws).to(dtype)
            cases.append(dict(
                name="rmsnorm_matmul_w8", shape=f"T={t},D={d},N={n},int8",
                kernel=lambda x=x, s=s, c=c, ws=ws: K.rmsnorm_matmul_w8(
                    x, s, c, w_scale=ws),
                plain=lambda x=x, s=s, c=c, ws=ws: ref.rmsnorm_matmul_w8(
                    x, s, c, ws),
                library=None,
                cublas=lambda xn=xn, wq=wq: torch.matmul(xn, wq),
                nbytes=(t * d + d + t * n) * isz + d * n + 4 * n,
                flops=2 * t * d * n, path=path))
        w_o = randn(d, d, scale=1 / math.sqrt(d))
        cases.append(dict(
            name="block_matmul", shape=f"o_proj M={t},K={d},N={d}",
            kernel=lambda x=x, w=w_o: K.block_matmul(x, w),
            plain=lambda x=x, w=w_o: ref.block_matmul(x, w),
            library=lambda x=x, w=w_o: torch.matmul(x, w), cublas=None,
            nbytes=(2 * t * d + d * d) * isz, flops=2 * t * d * d,
            path=path))
        wg = randn(d, f, scale=1 / math.sqrt(d))
        wu = randn(d, f, scale=1 / math.sqrt(d))
        wd = randn(f, d, scale=1 / math.sqrt(f))
        cases.append(dict(
            name="streamed_ffn", shape=f"T={t},D={d},F={f}",
            kernel=lambda x=x, s=s, a=wg, b=wu, c=wd: K.streamed_ffn(
                x, a, b, c, norm_scale=s),
            plain=lambda x=x, s=s, a=wg, b=wu, c=wd: ref.streamed_ffn(
                x, a, b, c, norm_scale=s),
            library=None,
            cublas=lambda xn=xn, a=wg, b=wu, c=wd: torch.matmul(
                torch.nn.functional.silu(xn @ a) * (xn @ b), c),
            nbytes=(2 * t * d + d + 3 * d * f) * isz, flops=6 * t * d * f,
            path=path))
        (cg, sg), (cu, su), (cd, sd) = _w8(torch, wg, wu, wd)
        wgq, wuq, wdq = ((c.float() * sc).to(dtype)
                         for c, sc in ((cg, sg), (cu, su), (cd, sd)))
        cases.append(dict(
            name="streamed_ffn_w8", shape=f"T={t},D={d},F={f},int8",
            kernel=lambda x=x, s=s, q=(cg, cu, cd, sg, su, sd):
                K.streamed_ffn_w8(x, *q[:3], wg_scale=q[3], wu_scale=q[4],
                                  wd_scale=q[5], norm_scale=s),
            plain=lambda x=x, s=s, q=(cg, cu, cd, sg, su, sd):
                ref.streamed_ffn_w8(x, *q[:3], wg_scale=q[3], wu_scale=q[4],
                                    wd_scale=q[5], norm_scale=s),
            library=None,
            cublas=lambda xn=xn, a=wgq, b=wuq, c=wdq: torch.matmul(
                torch.nn.functional.silu(xn @ a) * (xn @ b), c),
            nbytes=(2 * t * d + d) * isz + 3 * d * f + 4 * (2 * f + d),
            flops=6 * t * d * f, path=path))
    vocab = padded_vocab(128256)
    head = randn(d, vocab, scale=1 / math.sqrt(d))
    for t in (1, 4, SPEC_T):
        x = randn(t, d)
        s = randn(d, scale=0.1)
        xn = ref.rms_rows(x, s, 1e-6)
        cases.append(dict(
            name="rmsnorm_matmul", shape=f"lm_head T={t},D={d},N={vocab}",
            kernel=lambda x=x, s=s: K.rmsnorm_matmul(x, s, head),
            plain=lambda x=x, s=s: ref.rmsnorm_matmul(x, s, head),
            library=None, cublas=lambda xn=xn: torch.matmul(xn, head),
            nbytes=(t * d + d + d * vocab + t * vocab) * isz,
            flops=2 * t * d * vocab,
            path="speculative" if t == SPEC_T else None))
    cases += _attention_cases(torch, K, ref, randn, isz, gen, 32, 8, 128,
                              128, 2048, dev)
    # The training path at a step's 2 x 2048 tokens: the projections and
    # the FFN (their forward; the backward is PyTorch's) ...
    b, s = TRAIN_SHAPES["llama3-8b"]
    t = b * s
    x = randn(t, d)
    sc = randn(d, scale=0.1)
    xn = ref.rms_rows(x, sc, 1e-6)
    for n in (4096, 1024):
        w = randn(d, n, scale=1 / math.sqrt(d))
        cases.append(dict(
            name="rmsnorm_matmul", shape=f"T={t},D={d},N={n}", path="train",
            kernel=lambda x=x, w=w: K.rmsnorm_matmul(x, sc, w),
            plain=lambda x=x, w=w: ref.rmsnorm_matmul(x, sc, w),
            library=None, cublas=lambda w=w: torch.matmul(xn, w),
            nbytes=(t * d + d + d * n + t * n) * isz, flops=2 * t * d * n))
    wg, wu = (randn(d, f, scale=1 / math.sqrt(d)) for _ in range(2))
    wd = randn(f, d, scale=1 / math.sqrt(f))
    cases.append(dict(
        name="streamed_ffn", shape=f"T={t},D={d},F={f}", path="train",
        kernel=lambda: K.streamed_ffn(x, wg, wu, wd, norm_scale=sc),
        plain=lambda: ref.streamed_ffn(x, wg, wu, wd, norm_scale=sc),
        library=None,
        cublas=lambda: torch.matmul(
            torch.nn.functional.silu(xn @ wg) * (xn @ wu), wd),
        nbytes=(2 * t * d + d + 3 * d * f) * isz, flops=6 * t * d * f))
    # ... and the attention: the 2 sequences folded into the heads (64
    # query heads over 16 KV heads, GQA group 4), as
    # ``ops.flash_attention`` flattens them.
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", b * 32, b * 8,
                                  128, s, s, None, dev), path="train"))
    return cases


def gpt2_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """gpt2's kernel calls, as ``kernel_cases``: the projections (K = N =
    1024; the o-projection has the same shape), the MLP (D = 1024, F =
    4096, full precision and int8) and the LayerNorm rows at a prefill
    chunk, at decode, at a verify dispatch and at whole prompts of the
    serve burst's longest (992 rows) and shortest (37 rows: a partial
    tile, split K) lengths; the LM head (block_matmul over the padded
    vocabulary) at one row, decode and verify; attention at head dim 64
    with 16 query and 16 KV heads.  ``path`` tags the cases only
    whole-prompt admission or the speculative engine runs."""
    from repro_torch.models.params import padded_vocab
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    gelu = torch.nn.functional.gelu
    cases = []
    d, f = 1024, 4096
    for t in (128, 4, 992, 37, SPEC_T):
        path = ("whole_prompt" if t in (992, 37)
                else "speculative" if t == SPEC_T else None)
        x = randn(t, d)
        w = randn(d, d, scale=1 / math.sqrt(d))
        cases.append(dict(
            name="block_matmul", shape=f"M={t},K={d},N={d}",
            kernel=lambda x=x, w=w: K.block_matmul(x, w),
            plain=lambda x=x, w=w: ref.block_matmul(x, w),
            library=lambda x=x, w=w: torch.matmul(x, w), cublas=None,
            nbytes=(t * d + d * d + t * d) * isz, flops=2 * t * d * d,
            path=path))
        wu = randn(d, f, scale=1 / math.sqrt(d))
        wd = randn(f, d, scale=1 / math.sqrt(f))
        cases.append(dict(
            name="streamed_mlp", shape=f"T={t},D={d},F={f}",
            kernel=lambda x=x, a=wu, b=wd: K.streamed_mlp(x, a, b),
            plain=lambda x=x, a=wu, b=wd: ref.streamed_mlp(x, a, b),
            library=None,
            cublas=lambda x=x, a=wu, b=wd: torch.matmul(
                gelu(x @ a, approximate="tanh"), b),
            nbytes=(2 * t * d + 2 * d * f) * isz, flops=4 * t * d * f,
            path=path))
        (cu, su), (cd, sd) = _w8(torch, wu, wd)
        wuq, wdq = ((c.float() * sc).to(dtype) for c, sc in ((cu, su),
                                                            (cd, sd)))
        cases.append(dict(
            name="streamed_mlp_w8", shape=f"T={t},D={d},F={f},int8",
            kernel=lambda x=x, q=(cu, cd, su, sd): K.streamed_mlp_w8(
                x, q[0], q[1], wu_scale=q[2], wd_scale=q[3]),
            plain=lambda x=x, q=(cu, cd, su, sd): ref.streamed_mlp_w8(
                x, q[0], q[1], wu_scale=q[2], wd_scale=q[3]),
            library=None,
            cublas=lambda x=x, a=wuq, b=wdq: torch.matmul(
                gelu(x @ a, approximate="tanh"), b),
            nbytes=2 * t * d * isz + 2 * d * f + 4 * (f + d),
            flops=4 * t * d * f, path=path))
        sc, bi = randn(d), randn(d)
        cases.append(dict(
            name="row_norm", shape=f"T={t},D={d}",
            kernel=lambda x=x, a=sc, b=bi: K.layer_norm_rows(x, a, b),
            plain=lambda x=x, a=sc, b=bi: ref.layer_norm_rows(x, a, b),
            library=lambda x=x, a=sc, b=bi: torch.nn.functional.layer_norm(
                x, (d,), a, b, 1e-5), cublas=None,
            nbytes=(2 * t * d + 2 * d) * isz, flops=8 * t * d, path=path))
    vocab = padded_vocab(50257)
    head = randn(d, vocab, scale=1 / math.sqrt(d))
    for t in (1, 4, SPEC_T):
        x = randn(t, d)
        cases.append(dict(
            name="block_matmul", shape=f"lm_head M={t},K={d},N={vocab}",
            kernel=lambda x=x: K.block_matmul(x, head),
            plain=lambda x=x: ref.block_matmul(x, head),
            library=lambda x=x: torch.matmul(x, head), cublas=None,
            nbytes=(t * d + d * vocab + t * vocab) * isz,
            flops=2 * t * d * vocab,
            path="speculative" if t == SPEC_T else None))
    cases += _attention_cases(torch, K, ref, randn, isz, gen, 16, 16, 64, 64,
                              1024, dev)
    # The whole-prompt branch over a 1000-token prompt.
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", 16, 16, 64, 1000,
                                  1000, None, dev), path="whole_prompt"))
    # The training path at a step's 8 x 1024 tokens: the projections, the
    # MLP and the attention (the 8 sequences folded into 128 heads).
    b, s = TRAIN_SHAPES["gpt2"]
    t = b * s
    x = randn(t, d)
    w = randn(d, d, scale=1 / math.sqrt(d))
    cases.append(dict(
        name="block_matmul", shape=f"M={t},K={d},N={d}", path="train",
        kernel=lambda: K.block_matmul(x, w),
        plain=lambda: ref.block_matmul(x, w),
        library=lambda: torch.matmul(x, w), cublas=None,
        nbytes=(2 * t * d + d * d) * isz, flops=2 * t * d * d))
    wu = randn(d, f, scale=1 / math.sqrt(d))
    wd = randn(f, d, scale=1 / math.sqrt(f))
    cases.append(dict(
        name="streamed_mlp", shape=f"T={t},D={d},F={f}", path="train",
        kernel=lambda: K.streamed_mlp(x, wu, wd),
        plain=lambda: ref.streamed_mlp(x, wu, wd),
        library=None,
        cublas=lambda: torch.matmul(gelu(x @ wu, approximate="tanh"), wd),
        nbytes=(2 * t * d + 2 * d * f) * isz, flops=4 * t * d * f))
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", b * 16, b * 16,
                                  64, s, s, None, dev), path="train"))
    return cases


def xent_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """K11 at the training paths' shapes: gpt2 (T = 8 x 1024 tokens, D =
    1024, Vp = 50432 over its 50257-token vocabulary), llama3-8b (T =
    2 x 2048, D = 4096, Vp = vocab = 128256) and granite-moe-1b-a400m (T =
    2 x 2048, D = 1024, Vp = 49408 over 49155).  About 10% of the labels are
    ignored; the kernel gets them clamped to 0, as ``streamed_xent_loss``
    passes them.  The library yardstick is the cuBLAS chain ``h @ W``,
    ``torch.logsumexp`` and ``gather``."""
    from repro_torch.models.params import padded_vocab
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)

    def library(h, w, y, vocab):
        logits = (h @ w)[:, :vocab].float()
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(1, y.long()[:, None])[:, 0])

    cases = []
    for model, d, vocab in (("gpt2", 1024, 50257),
                            ("llama3-8b", 4096, 128256),
                            (GRANITE_TRAIN, 1024, 49155)):
        b, s = TRAIN_SHAPES[model]
        t, vp = b * s, padded_vocab(vocab)
        h = randn(t, d)
        w = randn(d, vp, scale=1 / math.sqrt(d))
        y = torch.randint(0, vocab, (t,), generator=gen, device=dev,
                          dtype=torch.int32)
        ignored = torch.rand(t, generator=gen, device=dev) < 0.1
        y = torch.where(ignored, 0, y).to(torch.int32)
        cases.append(dict(
            name="streamed_xent", model=model, path="train", head_dim=None,
            shape=f"T={t},D={d},Vp={vp},vocab={vocab},ignored=10%",
            kernel=lambda h=h, w=w, y=y, v=vocab: K.streamed_xent_parts(
                h, w, y, vocab_size=v),
            plain=lambda h=h, w=w, y=y, v=vocab: ref.xent_parts_ref(
                h, w, y, v),
            library=lambda h=h, w=w, y=y, v=vocab: library(h, w, y, v),
            cublas=None, nbytes=(t * d + d * vp) * isz + 3 * t * 4,
            flops=2 * t * d * vp))
    return cases


def _moe_inputs(torch, randn, t, d, f, e, top_k, dtype):
    """x [T, D], the real router's gates for it (top-k of softmax(x @ wr),
    renormalised: ``layers.gates_from_logits``) and the expert stacks."""
    from repro_torch.models.layers import gates_from_logits
    x = randn(t, d)
    wr = randn(d, e, scale=1 / math.sqrt(d))
    gates = gates_from_logits(x.float() @ wr.float(), top_k, dtype)
    wg, wu = (randn(e, d, f, scale=1 / math.sqrt(d)) for _ in range(2))
    wd = randn(e, f, d, scale=1 / math.sqrt(f))
    return x, wr, gates, wg, wu, wd


def _moe_library(torch, x, g, wg, wu, wd):
    """The same dense-gather work as cuBLAS calls: three batched products
    over the experts and the gate-weighted sum."""
    xe = x.expand(wg.shape[0], -1, -1)
    h = torch.nn.functional.silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    return torch.einsum("etd,te->td", torch.bmm(h, wd), g)


def granite_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """granite-moe's kernel calls (``model`` set per case): K12 at
    granite-3b's widths (D 1536, F 512, 40 experts, gates from a real
    router's top-8) at a decode step (T = 4), a verify dispatch (20), a
    prefill chunk (128) and a whole prompt (1000), and at granite-1b's (D
    1024, 32 experts) at a training step's 2 x 2048 tokens; the router
    product (block_matmul, N = 40) and ln2 (the row-norm kernel's RMSNorm
    mode) at the serving shapes; the qkv and LM-head rmsnorm_matmul calls
    (N = 1536 for q, 512 for k and v, 49408 for the padded vocabulary);
    attention at head dim 64 with 24 query and 8 KV heads (3b), its
    whole-prompt branch, and the training path's attention, qkv and loss
    at granite-1b's widths."""
    from repro_torch.models.params import padded_vocab
    isz = torch.empty((), dtype=dtype).element_size()
    randn = _randn(torch, gen, dtype, dev)
    cases = []
    d, f, e, top_k = 1536, 512, 40, 8

    def moe_case(model, t, d, e, path):
        x, wr, g, wg, wu, wd = _moe_inputs(torch, randn, t, d, f, e, top_k,
                                           dtype)
        # The bound counts what this router's gates need: the experts
        # some token kept, read once, and 6 D F operations per kept
        # (token, expert) pair.  The dense-gather work K12 and the library
        # chain do (every expert for every token) is reported beside it.
        kept = g != 0
        pairs, touched = int(kept.sum()), int(kept.any(0).sum())
        return x, wr, dict(
            name="moe_experts", model=model, path=path,
            shape=f"T={t},D={d},F={f},E={e},top_k={top_k}",
            kernel=lambda: K.moe_experts(x, g, wg, wu, wd),
            plain=lambda: ref.moe_experts(x, g, wg, wu, wd),
            library=lambda: _moe_library(torch, x, g, wg, wu, wd),
            cublas=None,
            nbytes=(2 * t * d + t * e + 3 * touched * d * f) * isz,
            flops=6 * d * f * pairs,
            dense=dict(gate_pairs=pairs, experts_touched=touched,
                       dense_bytes=(2 * t * d + t * e + 3 * e * d * f) * isz,
                       dense_flops=6 * t * d * f * e))

    for t in (4, SPEC_T, 128, 1000):
        path = {SPEC_T: "speculative", 1000: "whole_prompt"}.get(t)
        x, wr, case = moe_case(GRANITE, t, d, e, path)
        cases.append(case)
        cases.append(dict(
            name="block_matmul", model=GRANITE, path=path,
            shape=f"router M={t},K={d},N={e}",
            kernel=lambda x=x, w=wr: K.block_matmul(x, w),
            plain=lambda x=x, w=wr: ref.block_matmul(x, w),
            library=lambda x=x, w=wr: torch.matmul(x, w), cublas=None,
            nbytes=(t * d + d * e + t * e) * isz, flops=2 * t * d * e))
        s = randn(d, scale=0.1)
        w1 = (1.0 + s.float()).to(dtype)
        cases.append(dict(
            name="rms_norm_rows", model=GRANITE, path=path,
            shape=f"T={t},D={d}",
            kernel=lambda x=x, s=s: K.rms_norm_rows(x, s),
            plain=lambda x=x, s=s: ref.rms_rows(x, s, 1e-6),
            library=lambda x=x, w1=w1: torch.nn.functional.rms_norm(
                x, (d,), w1, 1e-6),
            cublas=None, nbytes=(2 * t * d + d) * isz, flops=4 * t * d))
        if t == 1000:
            continue
        xn = ref.rms_rows(x, s, 1e-6)
        for n in (1536, 512):
            w = randn(d, n, scale=1 / math.sqrt(d))
            cases.append(dict(
                name="rmsnorm_matmul", model=GRANITE, path=path,
                shape=f"T={t},D={d},N={n}",
                kernel=lambda x=x, s=s, w=w: K.rmsnorm_matmul(x, s, w),
                plain=lambda x=x, s=s, w=w: ref.rmsnorm_matmul(x, s, w),
                library=None,
                cublas=lambda xn=xn, w=w: torch.matmul(xn, w),
                nbytes=(t * d + d + d * n + t * n) * isz,
                flops=2 * t * d * n))
    vocab = padded_vocab(49155)
    head = randn(d, vocab, scale=1 / math.sqrt(d))
    for t in (1, 4, SPEC_T):
        x = randn(t, d)
        s = randn(d, scale=0.1)
        xn = ref.rms_rows(x, s, 1e-6)
        cases.append(dict(
            name="rmsnorm_matmul", model=GRANITE,
            path="speculative" if t == SPEC_T else None,
            shape=f"lm_head T={t},D={d},N={vocab}",
            kernel=lambda x=x, s=s: K.rmsnorm_matmul(x, s, head),
            plain=lambda x=x, s=s: ref.rmsnorm_matmul(x, s, head),
            library=None, cublas=lambda xn=xn: torch.matmul(xn, head),
            nbytes=(t * d + d + d * vocab + t * vocab) * isz,
            flops=2 * t * d * vocab))
    cases += [dict(c, model=GRANITE) for c in _attention_cases(
        torch, K, ref, randn, isz, gen, 24, 8, 64, 128, 2048, dev)]
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", 24, 8, 64, 1000,
                                  1000, None, dev),
                      model=GRANITE, path="whole_prompt"))
    # granite-1b's training step (2 x 2048 tokens): the experts, the qkv
    # projections (N = 1024 for q, 512 for k and v) and the attention
    # (2 sequences folded into 32 query heads over 16 KV heads).
    b, sl = TRAIN_SHAPES[GRANITE_TRAIN]
    t, d1 = b * sl, 1024
    x, _, case = moe_case(GRANITE_TRAIN, t, d1, 32, "train")
    cases.append(case)
    sc = randn(d1, scale=0.1)
    xn = ref.rms_rows(x, sc, 1e-6)
    for n in (1024, 512):
        w = randn(d1, n, scale=1 / math.sqrt(d1))
        cases.append(dict(
            name="rmsnorm_matmul", model=GRANITE_TRAIN, path="train",
            shape=f"T={t},D={d1},N={n}",
            kernel=lambda w=w: K.rmsnorm_matmul(x, sc, w),
            plain=lambda w=w: ref.rmsnorm_matmul(x, sc, w),
            library=None, cublas=lambda w=w: torch.matmul(xn, w),
            nbytes=(t * d1 + d1 + d1 * n + t * n) * isz,
            flops=2 * t * d1 * n))
    cases.append(dict(_flash_case(torch, K, ref, randn, isz,
                                  "flash_attention_static", b * 16, b * 8,
                                  64, sl, sl, None, dev),
                      model=GRANITE_TRAIN, path="train"))
    return cases


def _flat(torch, out):
    """A kernel's output, its parts concatenated when it has several
    (streamed_xent: lse and gold)."""
    if isinstance(out, tuple):
        return torch.cat([o.reshape(-1) for o in out])
    return out


def check_kernels(torch, timer):
    from repro_torch import kernels as K
    from repro_torch.kernels import ref
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        gen = torch.Generator(device="cuda").manual_seed(1234)
        cases = [dict(c, model="llama3-8b")
                 for c in kernel_cases(torch, K, ref, dtype, gen)]
        cases += [dict(c, model="gpt2")
                  for c in gpt2_kernel_cases(torch, K, ref, dtype, gen)]
        cases += xent_cases(torch, K, ref, dtype, gen)
        cases += granite_kernel_cases(torch, K, ref, dtype, gen)
        for c in cases:
            out = _flat(torch, c["kernel"]())
            torch.cuda.synchronize()
            want = _flat(torch, c["plain"]())
            err = (out.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            rel = err / max(scale, 1e-30)
            bound_ms, bound_by = bound(c["nbytes"], c["flops"], dname)
            # Each verify row against the decode kernel at its length, bit
            # for bit (comparison launches; no path's count).
            same_rows = (c["rows_vs_decode"](out) if "rows_vs_decode" in c
                         else None)
            row = {"phase": "kernel", "name": c["name"], "model": c["model"],
                   "head_dim": c.get("head_dim"), "path": c.get("path"),
                   "dtype": dname,
                   "shape": c["shape"], "max_abs_err": err,
                   "max_abs_ref": scale, "rel_err": rel, "tol": TOL[dname],
                   "ok": bool(rel <= TOL[dname] and math.isfinite(err)
                              and (same_rows is None or all(same_rows))),
                   "rows_equal_decode": same_rows,
                   "ms": timer(c["kernel"]), "plain_ms": timer(c["plain"]),
                   "library_ms": (timer(c["library"])
                                  if c["library"] is not None else None),
                   "cublas_ms": (timer(c["cublas"])
                                 if c["cublas"] is not None else None),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bytes": c["nbytes"], "flops": c["flops"]}
            if "dense" in c:
                row.update(c["dense"], dense_bound_ms=bound(
                    c["dense"]["dense_bytes"], c["dense"]["dense_flops"],
                    dname)[0])
            emit(row)
            rows.append(row)
            if c["name"] in ("paged_attention", "paged_attention_q"):
                zero = out[3].float().abs().max().item()
                if zero != 0.0:
                    raise AssertionError(f"{c['name']}: a length-0 slot "
                                         f"gave |out| up to {zero}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("kernels disagree with their plain versions: "
                             + "; ".join(f"{r['name']} {r['dtype']} "
                                         f"{r['shape']} rel {r['rel_err']} "
                                         f"rows {r['rows_equal_decode']}"
                                         for r in bad))
    return rows


def _same_rows(torch, fn, x, model, dname, name, counts):
    """Whether ``fn`` gives rows 0..3 (row 0 at a count of 1) the bits it
    gives them at 4 rows, at each row count; emitted as a row."""
    base = fn(x[:SLOTS].contiguous())
    same = {t: bool(torch.equal(fn(x[:t].contiguous())[:min(t, SLOTS)],
                                base[:min(t, SLOTS)]))
            for t in counts}
    row = {"phase": "row_invariance", "model": model, "dtype": dname,
           "call": name, "equal_to_T4": same,
           "required": "torch" not in name}
    emit(row)
    return row


def check_row_invariance(torch):
    """Bit-for-bit: rows 0..3 of each call on the kernel plan's path at T
    rows (8, 12, 20: verify windows of 2, 3 and 5 over 4 slots) against
    the same call at T = 4 (a decode step), at llama3's and gpt2's shapes,
    in bfloat16 and float32: the projection and FFN kernels and their int8
    twins, the o-projection (block_matmul), the final norm with the LM head
    (rmsnorm_matmul over the padded vocabulary; gpt2: block_matmul) and
    gpt2's LayerNorm (row_norm); and granite-moe-3b's MoE stage at 1, 8,
    12, 20 and 64 rows (its parts and the whole).  Exact acceptance needs
    every one of them to pass (required; the MoE gate arithmetic is
    PyTorch's but on the path, so required too).  The eager plan's
    PyTorch calls at the same shapes (``torch.matmul``, PyTorch's norms)
    are reported beside them."""
    from repro_torch import kernels as K
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.params import padded_vocab
    out, bad = [], []
    widths = {"llama3-8b": (4096, 14336), "gpt2": (1024, 4096)}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        gen = torch.Generator(device="cuda").manual_seed(99)
        randn = _randn(torch, gen, dtype, "cuda")
        for model, (d, f) in widths.items():
            vocab = padded_vocab(get_config(model).vocab_size)
            x = randn(SPEC_T, d)
            s = randn(d, scale=0.1)
            w_o = randn(d, d, scale=1 / math.sqrt(d))
            w_k = randn(d, d // 4 if model == "llama3-8b" else d,
                        scale=1 / math.sqrt(d))
            wu = randn(d, f, scale=1 / math.sqrt(d))
            wg = randn(d, f, scale=1 / math.sqrt(d))
            wd = randn(f, d, scale=1 / math.sqrt(f))
            head = randn(d, vocab, scale=1 / math.sqrt(d))
            (ck, sk), (cg, sg), (cu, su), (cd, sd) = _w8(torch, w_k, wg, wu,
                                                         wd)
            calls = {"o_proj block_matmul": lambda a: K.block_matmul(a, w_o),
                     "o_proj torch.matmul": lambda a: torch.matmul(a, w_o),
                     "lm_head torch.matmul": lambda a: torch.matmul(a, head)}
            if model == "llama3-8b":
                calls.update({
                    "lm_head rmsnorm_matmul": (
                        lambda a: K.rmsnorm_matmul(a, s, head)),
                    "final rms_norm torch": lambda a: L.rms_norm(a, s),
                    "rmsnorm_matmul N=4096": (
                        lambda a: K.rmsnorm_matmul(a, s, w_o)),
                    "rmsnorm_matmul N=1024": (
                        lambda a: K.rmsnorm_matmul(a, s, w_k)),
                    "rmsnorm_matmul_w8 N=1024": (
                        lambda a: K.rmsnorm_matmul_w8(a, s, ck, w_scale=sk)),
                    "streamed_ffn": (
                        lambda a: K.streamed_ffn(a, wg, wu, wd,
                                                 norm_scale=s)),
                    "streamed_ffn_w8": (
                        lambda a: K.streamed_ffn_w8(
                            a, cg, cu, cd, wg_scale=sg, wu_scale=su,
                            wd_scale=sd, norm_scale=s))})
            else:
                calls.update({
                    "lm_head block_matmul": (
                        lambda a: K.block_matmul(a, head)),
                    "layer_norm row_norm": (
                        lambda a: K.layer_norm_rows(a, s, s)),
                    "layer_norm torch": lambda a: L.layer_norm(a, s, s),
                    "block_matmul": lambda a: K.block_matmul(a, w_k),
                    "streamed_mlp": lambda a: K.streamed_mlp(a, wu, wd),
                    "streamed_mlp_w8": (
                        lambda a: K.streamed_mlp_w8(a, cu, cd, wu_scale=su,
                                                    wd_scale=sd))})
            for name, fn in calls.items():
                row = _same_rows(torch, fn, x, model, dname, name,
                                 (2 * SLOTS, 3 * SLOTS, SPEC_T))
                out.append(row)
                if row["required"] and not all(row["equal_to_T4"].values()):
                    bad.append(f"{model} {dname} {name} "
                               f"{row['equal_to_T4']}")
        # granite-moe-3b's MoE stage at 1..64 rows: ln2 (the row-norm
        # kernel's RMSNorm mode), the router product (block_matmul), the
        # gate arithmetic (PyTorch's softmax, top-k threshold and row sum),
        # the experts (K12, on fixed gates) and the whole stage.
        from repro_torch.models.layers import gates_from_logits
        d, f, e = 1536, 512, 40
        x, wr, g, wg, wu, wd = _moe_inputs(torch, randn, 64, d, f, e, 8,
                                           dtype)
        s = randn(d, scale=0.1)

        def stage(a):
            h = K.rms_norm_rows(a, s)
            return K.moe_experts(h, gates_from_logits(
                K.block_matmul(h, wr), 8, a.dtype), wg, wu, wd)

        calls = {
            "rms_norm_rows": lambda a: K.rms_norm_rows(a, s),
            "router block_matmul": lambda a: K.block_matmul(a, wr),
            "moe gates (PyTorch ops)": lambda a: gates_from_logits(
                K.block_matmul(a, wr), 8, a.dtype),
            "moe_experts": lambda a: K.moe_experts(
                a, g[:a.shape[0]].contiguous(), wg, wu, wd),
            "moe stage": stage,
            "rms_norm torch": lambda a: L.rms_norm(a, s)}
        for name, fn in calls.items():
            row = _same_rows(torch, fn, x, GRANITE, dname, name,
                             (1, 2 * SLOTS, 3 * SLOTS, SPEC_T, 64))
            out.append(row)
            if row["required"] and not all(row["equal_to_T4"].values()):
                bad.append(f"{GRANITE} {dname} {name} {row['equal_to_T4']}")
    if bad:
        raise AssertionError("rows change with the row count: "
                             + "; ".join(bad))
    return out


# --------------------------------------------------------------------- #
# Phases 3 and 4: the serving engine
# --------------------------------------------------------------------- #

def burst(rng, vocab: int, lengths):
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def _sync(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def _weights(torch, cfg, seed: int, jitter: bool, device="cuda"):
    """Random weights drawn on the card from ``seed``; jittered for the
    LayerNorm configs, whose zero-initialised norm scales would zero every
    logit and make any comparison pass for nothing."""
    from repro_torch.models import init_params
    from repro_torch.serving.accuracy import jitter_params
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device=device)
    if jitter:
        params = jitter_params(
            params, torch.Generator(device=device).manual_seed(seed + 10))
    return params


def _fused_eager(torch, cfg, params, prompts, chunked, device="cuda"):
    """One burst with the kernel plan and one with the eager plan:
    ({fused: tokens}, {fused: seconds}, the kernel plan's launches)."""
    from repro_torch import kernels as K
    from repro_torch.serving import ServingEngine
    tokens, seconds = {}, {}
    for fused in (True, False):
        eng = ServingEngine(
            dataclasses.replace(cfg, use_fused_kernels=fused), params,
            batch_slots=4, max_len=512, chunked=chunked, device=device)
        K.reset_launches()
        t0 = time.perf_counter()
        reqs = eng.generate(prompts, max_new_tokens=8)
        _sync(torch, device)
        seconds[fused] = time.perf_counter() - t0
        tokens[fused] = [r.out_tokens for r in reqs]
        if fused:
            launches = {k: n for k, n in K.launch_counts().items() if n}
    return tokens, seconds, launches


def _free(torch, device):
    if device == "cuda":
        torch.cuda.empty_cache()


def fused_vs_eager(torch, cfg, device="cuda", lengths=(150, 40, 300, 9)):
    """``cfg``: llama3-8b cut to 4 layers, float32."""
    params = _weights(torch, cfg, 1, jitter=False, device=device)
    prompts = burst(np.random.default_rng(1), cfg.vocab_size, lengths)
    tokens, seconds, _ = _fused_eager(torch, cfg, params, prompts, True,
                                      device)
    equal = tokens[True] == tokens[False]
    row = {"phase": "fused_vs_eager", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts],
           "new_tokens": 8, "tokens_equal": equal,
           "fused_s": seconds[True], "eager_s": seconds[False],
           "fused_tokens": tokens[True], "eager_tokens": tokens[False]}
    emit(row)
    del params
    _free(torch, device)
    if not equal:
        raise AssertionError("fused and eager plans gave different greedy "
                             "tokens")
    return row


def admission_fused_vs_eager(torch, cfg, *, jitter, phase, expect,
                             device="cuda", lengths=(150, 40, 300, 9)):
    """``cfg``: a model with both admission paths (gpt2 with jittered
    weights, granite-moe-3b) cut to 4 layers, float32.  Fused and eager
    tokens must agree under each admission mode, and the kernel plan's
    burst must launch exactly ``expect[mode]``.  Whether chunked and
    whole-prompt tokens agree is reported, not required: the two sum
    attention in different orders."""
    params = _weights(torch, cfg, 1, jitter=jitter, device=device)
    prompts = burst(np.random.default_rng(1), cfg.vocab_size, lengths)
    row = {"phase": phase, "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts], "new_tokens": 8}
    fused_tokens, bad = {}, []
    for mode, chunked in (("chunked", True), ("whole_prompt", False)):
        tokens, seconds, launches = _fused_eager(
            torch, cfg, params, prompts, chunked, device)
        row[mode] = {"tokens_equal": tokens[True] == tokens[False],
                     "fused_s": seconds[True], "eager_s": seconds[False],
                     "fused_tokens": tokens[True],
                     "eager_tokens": tokens[False], "launches": launches}
        fused_tokens[mode] = tokens[True]
        if not row[mode]["tokens_equal"]:
            bad.append(f"{mode}: kernel plan != eager plan")
        if set(launches) != expect[mode]:
            bad.append(f"{mode}: launched {sorted(launches)}, expected "
                       f"{sorted(expect[mode])}")
    row["chunked_equals_whole_prompt"] = (fused_tokens["chunked"]
                                          == fused_tokens["whole_prompt"])
    emit(row)
    del params
    _free(torch, device)
    if bad:
        raise AssertionError(f"{phase} {cfg.name}: " + "; ".join(bad))
    return row


def serve(torch, cfg, params, expect, *, init_s, chunked=True,
          phase="serve", device="cuda", max_len=2048, lo=37, hi=1000,
          new=32):
    """A mixed burst of 8 prompts through the engine with the kernel plan;
    the kernels in ``expect`` must each launch, and no other."""
    from repro_torch import kernels as K
    from repro_torch.models.params import weight_bytes
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import COUNTER_NAMES
    rng = np.random.default_rng(2)
    lengths = [lo, hi] + [int(n) for n in rng.integers(lo, hi + 1, 6)]
    prompts = burst(rng, cfg.vocab_size, lengths)
    eng = ServingEngine(cfg, params, batch_slots=4, max_len=max_len,
                        chunked=chunked, device=device)
    eng.generate([prompts[2][:8]], max_new_tokens=2)       # warm-up
    _sync(torch, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = dict(eng.metrics)
    K.reset_launches()
    t0 = time.perf_counter()
    reqs = eng.generate(prompts, max_new_tokens=new)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    burst_metrics = {k: eng.metrics[k] - before[k] for k in COUNTER_NAMES}
    solo = eng.generate([prompts[0]], max_new_tokens=new)[0].out_tokens
    generated = sum(len(r.out_tokens) for r in reqs)
    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs]
    row = {"phase": phase, "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "quant": cfg.quant,
           "admission": "chunked" if chunked else "whole_prompt",
           # Resident weights of the engine's tree: int8 codes and scales
           # in place of the w8 stages' weights under a weight mode.
           "weight_bytes": weight_bytes(eng.params), "init_s": init_s,
           "slots": 4, "max_len": max_len, "prompt_lengths": lengths,
           "new_tokens": new, "wall_s": wall, "generated": generated,
           "tokens_per_s": generated / wall,
           "ttft_p50_s": statistics.median(ttft),
           "ttft_max_s": max(ttft),
           "tpot_mean_ms": 1e3 * statistics.mean(tpot),
           "kv_bytes_peak": eng.metrics["kv_bytes_peak"],
           "kv_itemsize_effective": eng.metrics["kv_itemsize_effective"],
           "device_mem_peak": (torch.cuda.max_memory_allocated()
                               if device == "cuda" else None),
           "metrics": burst_metrics, "launches": counts,
           "solo_repeats_burst": solo == reqs[0].out_tokens,
           "first_tokens": reqs[0].out_tokens[:8]}
    emit(row)
    problems = []
    for name, c in counts.items():
        if (c > 0) != (name in expect):
            problems.append(f"{name} launched {c} times")
    for r in reqs:
        if r.failed or not r.done or len(r.out_tokens) != new:
            problems.append(f"request {r.rid}: done={r.done} failed="
                            f"{r.failed} tokens={len(r.out_tokens)}")
        if any(not 0 <= t < cfg.vocab_size for t in r.out_tokens):
            problems.append(f"request {r.rid}: token outside the vocab")
    if not row["solo_repeats_burst"]:
        problems.append("the first prompt served alone gave other tokens")
    if problems:
        raise AssertionError(f"{phase}: " + "; ".join(problems))
    return row


# --------------------------------------------------------------------- #
# Phases 7 and 8: speculative decoding over the prefix cache
# --------------------------------------------------------------------- #

def spec_burst(vocab: int):
    """8 prompts for 4 slots: one shared 512-token prefix (four 128-token
    chunks: the system prompt chat and agent traffic repeats) with distinct
    random suffixes of 37..480 tokens (numpy seed 2), the last two
    repeating the second and third verbatim; at most 992 tokens, so every
    request gets 32 new tokens in gpt2's 1024-position context."""
    rng = np.random.default_rng(2)
    shared = rng.integers(0, vocab, 512).astype(np.int32)
    lengths = [37, 480] + [int(n) for n in rng.integers(37, 481, 4)]
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)
                               .astype(np.int32)]) for n in lengths]
    return prompts + [prompts[1].copy(), prompts[2].copy()]


def _first_divergence(a, b):
    """Index of the first token where two outputs differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


SPEC_ENGINES = {
    "plain": dict(prefix_cache=False),
    "default": {},
    "speculative": dict(speculative=True, draft_len=4),
    "speculative_eager": dict(speculative=True, draft_len=4, fused=False),
}


def spec_fused_vs_eager(torch, cfg, *, jitter, max_len, expect,
                        device="cuda", new=32):
    """``cfg``: full width cut to 4 layers, float32, kernel plan.  The four
    engines of ``SPEC_ENGINES`` must give the same greedy tokens on the
    speculative burst, and the speculative engine on the kernel plan must
    launch exactly the kernels of ``expect``."""
    from repro_torch import kernels as K
    from repro_torch.serving import ServingEngine
    params = _weights(torch, cfg, 1, jitter=jitter, device=device)
    prompts = spec_burst(cfg.vocab_size)
    row = {"phase": "spec_fused_vs_eager", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts], "new_tokens": new}
    tokens = {}
    for name, kw in SPEC_ENGINES.items():
        kw = dict(kw)
        run_cfg = dataclasses.replace(cfg, use_fused_kernels=kw.pop(
            "fused", True))
        eng = ServingEngine(run_cfg, params, batch_slots=SLOTS,
                            max_len=max_len, device=device, **kw)
        K.reset_launches()
        t0 = time.perf_counter()
        reqs = eng.generate(prompts, max_new_tokens=new)
        _sync(torch, device)
        tokens[name] = [r.out_tokens for r in reqs]
        m = eng.metrics
        row[name] = {"seconds": time.perf_counter() - t0,
                     "launches": {k: n for k, n in K.launch_counts().items()
                                  if n},
                     "equal_to_plain": tokens[name] == tokens["plain"],
                     "first_divergence": [
                         _first_divergence(a, b) for a, b in
                         zip(tokens[name], tokens["plain"])],
                     **{k: m[k] for k in (
                         "prefix_hit_pages", "draft_tokens",
                         "accepted_tokens", "verify_dispatches",
                         "rollbacks", "dispatches")}}
        del eng
    row["plain_tokens"] = tokens["plain"]
    emit(row)
    del params
    _free(torch, device)
    bad = [n for n in SPEC_ENGINES if not row[n]["equal_to_plain"]]
    if bad:
        raise AssertionError(f"{cfg.name}: {bad} gave other greedy tokens "
                             "than the plain engine")
    spec_launches = set(row["speculative"]["launches"])
    if spec_launches != expect:
        raise AssertionError(f"{cfg.name}: the speculative engine launched "
                             f"{sorted(spec_launches)}, expected "
                             f"{sorted(expect)}")
    return row


def spec_serve(torch, cfg, params, expect, *, init_s, max_len,
               require_equal=True, phase="spec_serve", device="cuda",
               new=32):
    """``cfg``: full width and depth, bfloat16, kernel plan.  The
    speculative burst through the speculative engine (prefix cache on),
    then through the plain engine for per-request token equality, which
    ``require_equal`` makes a condition of the run: every call on the
    kernel plan's path is row-invariant, so verify rows reproduce decode
    rows bit for bit.  Under KV quantization it is reported only: rejected
    draft rows leave their pages' scale growth behind, as the reference
    does (``kv_cache.py:848``), so later codes may differ from the plain
    engine's."""
    from repro_torch import kernels as K
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import COUNTER_NAMES
    prompts = spec_burst(cfg.vocab_size)
    eng = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=max_len,
                        speculative=True, draft_len=4, device=device)
    eng.generate([prompts[2][:8]], max_new_tokens=2)       # warm-up
    _sync(torch, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = dict(eng.metrics)
    K.reset_launches()
    t0 = time.perf_counter()
    reqs = eng.generate(prompts, max_new_tokens=new)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    m = eng.metrics
    burst_metrics = {k: m[k] - before[k] for k in COUNTER_NAMES}
    kv_peak = m["kv_bytes_peak"]
    mem_peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else None)
    del eng
    _free(torch, device)
    plain = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=max_len,
                          prefix_cache=False, device=device)
    t1 = time.perf_counter()
    base = [r.out_tokens for r in plain.generate(prompts,
                                                 max_new_tokens=new)]
    _sync(torch, device)
    plain_wall = time.perf_counter() - t1
    del plain
    _free(torch, device)
    generated = sum(len(r.out_tokens) for r in reqs)
    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs]
    bm = burst_metrics
    row = {"phase": phase, "config": cfg.name, "quant": cfg.quant,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "init_s": init_s,
           "slots": SLOTS, "max_len": max_len,
           "prompt_lengths": [len(p) for p in prompts], "new_tokens": new,
           "wall_s": wall, "generated": generated,
           "tokens_per_s": generated / wall,
           "ttft_p50_s": statistics.median(ttft), "ttft_max_s": max(ttft),
           "tpot_mean_ms": 1e3 * statistics.mean(tpot),
           "accept_rate": bm["accepted_tokens"] / max(bm["draft_tokens"], 1),
           "dispatches_per_token": (bm["verify_dispatches"]
                                    / max(bm["spec_tokens"], 1)),
           "prefix_hit_rate": (bm["prefix_hit_pages"]
                               / max(bm["prompt_pages"], 1)),
           "rollbacks": bm["rollbacks"], "kv_bytes_peak": kv_peak,
           "device_mem_peak": mem_peak, "metrics": burst_metrics,
           "launches": counts, "plain_wall_s": plain_wall,
           "plain_tokens_per_s": generated / plain_wall,
           "equal_to_plain": [r.out_tokens == b for r, b in zip(reqs, base)],
           "equal_required": require_equal,
           "first_divergence": [_first_divergence(r.out_tokens, b)
                                for r, b in zip(reqs, base)]}
    emit(row)
    problems = []
    for name, c in counts.items():
        if (c > 0) != (name in expect):
            problems.append(f"{name} launched {c} times")
    for r in reqs:
        if r.failed or not r.done or len(r.out_tokens) != new:
            problems.append(f"request {r.rid}: done={r.done} failed="
                            f"{r.failed} tokens={len(r.out_tokens)}")
        if any(not 0 <= t < cfg.vocab_size for t in r.out_tokens):
            problems.append(f"request {r.rid}: token outside the vocab")
    if bm["prefix_hit_pages"] <= 0:
        problems.append("no prefix page was hit")
    if bm["rollbacks"] <= 0:
        problems.append("no draft was rolled back")
    if require_equal and not all(row["equal_to_plain"]):
        problems.append("speculative tokens differ from the plain engine's "
                        f"at {row['first_divergence']}")
    if problems:
        raise AssertionError(f"{phase} {cfg.name}: " + "; ".join(problems))
    return row


# --------------------------------------------------------------------- #
# Phases 9-11: quantized serving
# --------------------------------------------------------------------- #

def quant_fused_vs_eager(torch, cfg, *, jitter, device="cuda",
                         lengths=(150, 40, 300, 9), new=8):
    """``cfg``: full width cut to 4 layers, float32, kernel plan.  Under
    every quant mode the kernel plan must give the eager plan's greedy
    tokens; the eager plan of a weight mode runs on the eager w8 reference
    (each w8 stage's weight quantized and dequantized back), since the
    reference's eager plan keeps full-precision weights.  Under kv_int8 the
    speculative engine (prefix cache on) must give the plain engine's
    tokens."""
    from repro_torch import kernels as K
    from repro_torch.models.params import dequantize_weights, quantize_weights
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.accuracy import QUANT_MODES
    params = _weights(torch, cfg, 1, jitter=jitter, device=device)
    prompts = burst(np.random.default_rng(1), cfg.vocab_size, lengths)
    eager_cfg = dataclasses.replace(cfg, use_fused_kernels=False)
    kw = dict(batch_slots=SLOTS, max_len=512, device=device)
    row = {"phase": "quant_fused_vs_eager", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts], "new_tokens": new}
    bad = []
    for mode in QUANT_MODES:
        qcfg = dataclasses.replace(cfg, quant=mode)
        ref_params = dequantize_weights(qcfg, quantize_weights(qcfg, params))
        K.reset_launches()
        fused = [r.out_tokens for r in ServingEngine(
            qcfg, params, **kw).generate(prompts, max_new_tokens=new)]
        launches = {k: n for k, n in K.launch_counts().items() if n}
        eager = [r.out_tokens for r in ServingEngine(
            dataclasses.replace(eager_cfg, quant=mode), ref_params,
            **kw).generate(prompts, max_new_tokens=new)]
        del ref_params
        row[mode] = {"tokens_equal": fused == eager, "fused_tokens": fused,
                     "eager_tokens": eager, "launches": launches}
        if fused != eager:
            bad.append(f"{mode}: kernel plan != eager plan")
        if mode == "kv_int8":
            plain = [r.out_tokens for r in ServingEngine(
                qcfg, params, prefix_cache=False, **kw).generate(
                    prompts, max_new_tokens=new)]
            spec = ServingEngine(qcfg, params, speculative=True, draft_len=4,
                                 **kw)
            spec_tokens = [r.out_tokens for r in spec.generate(
                prompts, max_new_tokens=new)]
            row[mode].update(
                speculative_equal_plain=spec_tokens == plain,
                speculative_first_divergence=[
                    _first_divergence(a, b)
                    for a, b in zip(spec_tokens, plain)],
                draft_tokens=spec.metrics["draft_tokens"],
                accepted_tokens=spec.metrics["accepted_tokens"],
                rollbacks=spec.metrics["rollbacks"])
            if spec_tokens != plain:
                bad.append("kv_int8: speculative != plain")
        _free(torch, device)
    emit(row)
    del params
    _free(torch, device)
    if bad:
        raise AssertionError(f"quant_fused_vs_eager {cfg.name}: "
                             + "; ".join(bad))
    return row


def accuracy(torch, cfg, *, jitter, device="cuda"):
    """``cfg``: full width cut to 4 layers, float32.  The teacher-forced
    accuracy gate (``serving/accuracy.py``) of every quant mode against
    the unquantized engine on the kernel plan (weights jittered for gpt2
    only, as in the other phases): reported beside the reference's largest
    logit magnitude, and every logit error must be finite."""
    from repro_torch.serving.accuracy import QUANT_MODES, run_accuracy
    params = _weights(torch, cfg, 3, jitter=jitter, device=device)
    t0 = time.perf_counter()
    rep = run_accuracy(cfg, QUANT_MODES, params=params, fused=True,
                       device=device)
    row = {"phase": "accuracy", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": "float32",
           "seconds": time.perf_counter() - t0,
           "max_abs_logit": rep["none"]["max_abs_logit"],
           **{m: {k: rep[m][k] for k in ("max_logit_err", "tokens_equal",
                                         "kv_itemsize")}
              for m in QUANT_MODES}}
    emit(row)
    del params
    _free(torch, device)
    bad = [m for m in QUANT_MODES
           if not math.isfinite(rep[m]["max_logit_err"])]
    if bad:
        raise AssertionError(f"accuracy {cfg.name}: non-finite logit error "
                             f"under {bad}")
    return row


def full_depth(torch, cfg, model, *, jitter, max_len, hi, device="cuda"):
    """``cfg``: full width and depth, bfloat16, kernel plan; weights drawn
    once on the card (seed 2).  The mixed burst (``serve``; gpt2 and
    granite under chunked and whole-prompt admission), the speculative
    burst against the plain engine (``spec_serve``, exact), then both
    again under w8_kv8 (``quant_serve``, ``quant_spec_serve``).  Each
    burst launches exactly its path's kernels."""
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=jitter, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    modes = tuple(SERVE_PATHS[model])
    qcfg = dataclasses.replace(cfg, quant=QUANT_MODE)
    out = {"serve": {}, "quant_serve": {}}
    phase = {"llama3-8b": "serve", "gpt2": "gpt2_serve"}.get(
        model, "granite_serve")
    for mode in modes:
        out["serve"][mode] = serve(
            torch, cfg, params, SERVE_PATHS[model][mode], init_s=init_s,
            chunked=mode == "chunked", device=device, max_len=max_len, hi=hi,
            phase=phase)
        _free(torch, device)
    out["spec_serve"] = spec_serve(torch, cfg, params, SPEC_PATHS[model],
                                   init_s=init_s, max_len=max_len,
                                   device=device)
    for mode in modes:
        out["quant_serve"][mode] = serve(
            torch, qcfg, params, QUANT_PATHS[(model, mode)], init_s=init_s,
            chunked=mode == "chunked", device=device, max_len=max_len, hi=hi,
            phase="quant_serve")
        _free(torch, device)
    out["quant_spec_serve"] = spec_serve(
        torch, qcfg, params, QUANT_PATHS[(model, "speculative")],
        init_s=init_s, max_len=max_len, require_equal=False,
        phase="quant_spec_serve", device=device)
    del params
    _free(torch, device)
    return out


# --------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------- #

def _rel(got, want) -> float:
    """max |got - want| over max |want| (float64)."""
    d = (got.double() - want.double()).abs().max().item()
    return d / max(want.double().abs().max().item(), 1e-30)


def _train_counts(torch, K, expect):
    """The launch counts since the last reset, and what differs from
    ``expect`` (every other kernel must stay at 0)."""
    counts = {k: n for k, n in K.launch_counts().items() if n}
    bad = {k: (counts.get(k, 0), expect.get(k, 0))
           for k in set(counts) | set(expect)
           if counts.get(k, 0) != expect.get(k, 0)}
    return counts, bad


def train_fused_vs_eager(torch, cfg, model, *, jitter, device="cuda",
                         steps=3):
    """``cfg``: full width cut to 4 layers, float32.  On one batch (B = 2,
    S = 256, from the token pipeline) the kernel plan's ``forward_train``
    loss must equal the eager plan's at relative 1e-5 and every gradient
    leaf agree at relative 1e-4 (max |d| over max |eager|); then 3
    ``make_train_step`` steps from the same weights on each plan must give
    losses within relative 1e-4.  The kernel plan's launches in each step
    must be the plan's: the forward, the re-run of each layer under remat,
    the loss once (``train_step_launches``)."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import (AdamWConfig, init_opt_state,
                                         make_train_step)
    from repro_torch.models import forward_train, init_params
    from repro_torch.models.params import map_tree, tree_leaves
    from repro_torch.serving.accuracy import jitter_params
    params0 = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                          device=device, dtype=torch.float32)
    if jitter:
        params0 = jitter_params(
            params0, torch.Generator(device=device).manual_seed(11))
    pipe = TokenPipeline(cfg, ShapeConfig("smoke", 256, 2, "train"), seed=0)
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in pipe.batch_at(0).items()}
    expect = train_step_launches(model, cfg.num_layers)
    leaves = tree_leaves(params0)
    for p in leaves:
        p.requires_grad_(True)
    loss, grads = {}, {}
    for fused in (True, False):
        K.reset_launches()
        out = forward_train(params0, dataclasses.replace(
            cfg, use_fused_kernels=fused), batch)
        grads[fused] = torch.autograd.grad(out, leaves)
        _sync(torch, device)
        loss[fused] = float(out.detach())
        if fused:
            grad_counts, grad_bad = _train_counts(torch, K, expect)
    grad_rel = max(_rel(a, b) for a, b in zip(grads[True], grads[False]))
    del grads
    _free(torch, device)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=steps)
    losses, step_bad = {}, []
    for fused in (True, False):
        run_cfg = dataclasses.replace(cfg, use_fused_kernels=fused)
        params = map_tree(lambda t: t.detach().clone(), params0)
        opt = init_opt_state(params)
        step_fn = make_train_step(run_cfg, opt_cfg, device=device)
        losses[fused] = []
        for i in range(steps):
            K.reset_launches()
            params, opt, m = step_fn(params, opt, pipe.batch_at(i))
            losses[fused].append(float(m["loss"]))
            if fused:
                _, bad = _train_counts(torch, K, expect)
                if bad:
                    step_bad.append((i, bad))
        del params, opt
        _free(torch, device)
    step_rel = [abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                    losses[False])]
    row = {"phase": "train_fused_vs_eager", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype, "batch": 2,
           "seq_len": 256, "loss_fused": loss[True],
           "loss_eager": loss[False],
           "loss_rel": abs(loss[True] - loss[False]) / abs(loss[False]),
           "grad_rel_max": grad_rel, "step_losses_fused": losses[True],
           "step_losses_eager": losses[False], "step_loss_rel": step_rel,
           "launches_per_step": grad_counts, "expected_per_step": expect}
    emit(row)
    del params0, leaves
    _free(torch, device)
    problems = []
    if not row["loss_rel"] <= 1e-5:
        problems.append(f"loss rel {row['loss_rel']}")
    if not grad_rel <= 1e-4:
        problems.append(f"gradient rel {grad_rel}")
    if not all(r <= 1e-4 for r in step_rel):
        problems.append(f"step losses rel {step_rel}")
    if grad_bad or step_bad:
        problems.append(f"launches off the plan's: {grad_bad} {step_bad}")
    if problems:
        raise AssertionError(f"train_fused_vs_eager {cfg.name}: "
                             + "; ".join(problems))
    return row


# Device time by kernel name: the repository's kernels (name fragment ->
# what runs it on the training path), the rest is PyTorch's (cuBLAS for
# the eager backward and the o-projection, elementwise, norms, AdamW).
OWN_KERNELS = (("tiled_matmul_kernel", "projections (K3/K5)"),
               ("split_reduce_kernel", "float32 split sums (K3-K6, K12)"),
               ("streamed_ffn_kernel", "FFN (K4/K6)"),
               ("moe_", "MoE experts (K12)"),
               ("flash_offset_kernel", "attention (K7)"),
               ("xent_", "loss (K11)"))


def profile_step(torch, tr):
    """One more step of trainer ``tr`` under ``torch.profiler``: device
    milliseconds of the repository's kernels by stage and of PyTorch's
    kernels (cuBLAS gemms apart), and the step's wall under the profiler.
    None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    batch = tr.pipeline.batch_at(tr.step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.params, tr.opt_state, m = tr.step_fn(tr.params, tr.opt_state,
                                                batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    ms: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        stage = next((v for k, v in OWN_KERNELS if k in e.name), None)
        if stage is None:
            stage = ("PyTorch gemm" if any(
                k in e.name.lower() for k in ("gemm", "xmma", "cutlass"))
                else "PyTorch other")
        ms[stage] = ms.get(stage, 0.0) + e.time_range.elapsed_us() / 1e3
    if not ms:
        return None
    return {"device_ms": ms, "busy_ms": sum(ms.values()),
            "profiled_wall_ms": wall * 1e3}


def train(torch, cfg, model, *, steps, ckpt_every, replay_from, lr, note,
          device="cuda"):
    """``cfg``: full width (gpt2 also full depth), bfloat16 compute, kernel
    plan, through ``Trainer.run()``: float32 master weights and AdamW
    state drawn by the trainer (seed 0), token-pipeline batches of
    ``TRAIN_SHAPES[model]``, a checkpoint every ``ckpt_every`` steps
    (under ``build/train_ckpt/``, removed after).  With ``replay_from`` a
    second trainer resumes from that step's checkpoint and replays the
    steps after it; its losses must equal the first run's at relative
    1e-3 (bit equality is reported: the embedding's backward accumulates
    with atomics).  Every loss must be finite and the last below the
    first; the launches must be ``steps`` times the plan's per step."""
    import shutil
    from repro_torch import kernels as K
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    b, s = TRAIN_SHAPES[model]
    shape = ShapeConfig("train", s, b, "train")
    root = os.path.join(ROOT, "build", "train_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    first, second = (os.path.join(root, n) for n in ("run", "replay"))
    opt = AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps)
    # ckpt_every None: no checkpoint at all (the trainer writes one only
    # every ``checkpoint_every`` steps).
    tcfg = dict(total_steps=steps, checkpoint_every=ckpt_every or 10**9,
                log_every=10**9)
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, shape, TrainerConfig(checkpoint_dir=first, **tcfg),
                 opt, device=device)
    K.reset_launches()
    t0 = time.perf_counter()
    tr.run()
    _sync(torch, device)
    wall = time.perf_counter() - t0
    per_step = train_step_launches(model, cfg.num_layers)
    counts, bad = _train_counts(
        torch, K, {k: n * steps for k, n in per_step.items()})
    losses = [l for _, l in tr.history]
    step_s = statistics.median(tr.step_s[1:])
    row = {"phase": "train", "config": cfg.name, "layers": cfg.num_layers,
           "dtype": cfg.dtype, "master": "float32", "batch": b,
           "seq_len": s, "steps": steps, "lr": lr, "note": note,
           "losses": losses, "step_s": tr.step_s,
           "step_s_median_after_first": step_s,
           "tokens_per_s": b * s / step_s, "wall_s": wall,
           "device_mem_peak": torch.cuda.max_memory_allocated(),
           "ckpt_snapshot_s": tr.ckpt.snapshot_s,
           "ckpt_write_s": tr.ckpt.write_s,
           "disk_free_bytes": shutil.disk_usage(
               os.path.join(ROOT, "build")).free,
           "launches": counts, "launches_per_step_expected": per_step}
    # Where a step's time goes (one more step, after the counted run); the
    # idle share against the unprofiled median step.
    prof = profile_step(torch, tr)
    if prof is not None:
        prof["idle_share"] = 1 - prof["busy_ms"] / (1e3 * step_s)
    row["profile"] = prof
    del tr
    _free(torch, device)
    problems = []
    if replay_from:
        os.makedirs(second)
        name = f"step-{replay_from:08d}"
        os.replace(os.path.join(first, name), os.path.join(second, name))
        shutil.rmtree(first)
        tr2 = Trainer(cfg, shape, TrainerConfig(checkpoint_dir=second,
                                                **tcfg), opt, device=device)
        if not tr2.resume() or tr2.step != replay_from:
            problems.append(f"no resume at step {replay_from}")
        tr2.run()
        _sync(torch, device)
        replay = [l for _, l in tr2.history]
        row.update(restore_s=tr2.restore_s, replay_losses=replay,
                   replay_rel=[abs(a - b) / abs(b) for a, b in
                               zip(replay, losses[replay_from:])],
                   replay_bit_equal=replay == losses[replay_from:])
        if len(replay) != steps - replay_from or not all(
                r <= 1e-3 for r in row["replay_rel"]):
            problems.append(f"replayed losses {replay} against "
                            f"{losses[replay_from:]}")
        del tr2
    elif ckpt_every:
        # Time a restore of the last checkpoint (no replay).
        from repro_torch.train import latest_checkpoint, restore_checkpoint
        t1 = time.perf_counter()
        restored = restore_checkpoint(latest_checkpoint(first), cfg,
                                      device=device)
        _sync(torch, device)
        row["restore_s"] = time.perf_counter() - t1
        del restored
    _free(torch, device)
    shutil.rmtree(root, ignore_errors=True)
    emit(row)
    if not all(math.isfinite(l) for l in losses) or not losses[-1] < losses[0]:
        problems.append(f"losses {losses}: not finite or not falling")
    if bad:
        problems.append(f"launches off the plan's: {bad}")
    if problems:
        raise AssertionError(f"train {cfg.name}: " + "; ".join(problems))
    return row


# --------------------------------------------------------------------- #

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "chip_smoke"),
                    help="directory for chip_smoke.json and ptxas.txt")
    args = ap.parse_args(argv)

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import on_hopper

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "capability": list(torch.cuda.get_device_capability(0)),
          "sms": torch.cuda.get_device_properties(0).multi_processor_count,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if not on_hopper():
        print(f"chip_smoke: {name} is not a Hopper (sm_90) card; the "
              "kernels are built for sm_90a", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    built = _build.build_all()
    build = {"phase": "build", "seconds": time.perf_counter() - t0,
             "built": built, "nvcc": _build.find_nvcc()}
    emit(build)
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as fh:
        for n, log in _build.BUILD_LOG.items():
            fh.write(f"== {n}\n{log}\n")

    from repro_torch.configs import get_config
    llama, gpt2 = get_config("llama3-8b"), get_config("gpt2")
    results = {"device": smi, "name": name, "build": build}
    rows = check_kernels(torch, Timer(torch))
    results["kernel_checks"] = rows
    results["row_invariance"] = check_row_invariance(torch)
    models = {"llama3-8b": (llama, False, 2048, 1000),
              "gpt2": (gpt2, True, 1024, 992),
              GRANITE: (get_config(GRANITE), False, 2048, 1000)}
    small = {m: dataclasses.replace(c, num_layers=4, dtype="float32")
             for m, (c, _, _, _) in models.items()}
    results["fused_vs_eager"] = fused_vs_eager(torch, small["llama3-8b"])
    results["gpt2_fused_vs_eager"] = admission_fused_vs_eager(
        torch, small["gpt2"], jitter=True, phase="gpt2_fused_vs_eager",
        expect=GPT2_PATHS)
    results["granite_fused_vs_eager"] = admission_fused_vs_eager(
        torch, small[GRANITE], jitter=False, phase="granite_fused_vs_eager",
        expect=GRANITE_PATHS)
    results["spec_fused_vs_eager"] = {
        m: spec_fused_vs_eager(
            torch, dataclasses.replace(small[m], use_fused_kernels=True),
            jitter=jit, max_len=ml, expect=SPEC_PATHS[m])
        for m, (_, jit, ml, _) in models.items()}
    results["quant_fused_vs_eager"] = {
        m: quant_fused_vs_eager(
            torch, dataclasses.replace(small[m], use_fused_kernels=True),
            jitter=jit)
        for m, (_, jit, _, _) in models.items()}
    results["accuracy"] = {m: accuracy(torch, small[m], jitter=jit)
                           for m, (_, jit, _, _) in models.items()}
    results["full_depth"] = {
        m: full_depth(torch, dataclasses.replace(c, use_fused_kernels=True),
                      m, jitter=jit, max_len=ml, hi=hi)
        for m, (c, jit, ml, hi) in models.items()}
    results["train_fused_vs_eager"] = {
        m: train_fused_vs_eager(torch, small[m], m, jitter=jit)
        for m, (_, jit, _, _) in models.items()}
    results["train"] = {
        "gpt2": train(torch, dataclasses.replace(gpt2, use_fused_kernels=True),
                      "gpt2", steps=6, ckpt_every=3, replay_from=3, lr=1e-3,
                      note="full width and depth"),
        "llama3-8b": train(
            torch, dataclasses.replace(llama, num_layers=2,
                                       use_fused_kernels=True),
            "llama3-8b", steps=3, ckpt_every=3, replay_from=0, lr=3e-5,
            note="full width cut to 2 layers: float32 weights, gradients "
                 "and two AdamW moments of all 32 layers take 128 GB, the "
                 "card has 80, and 2 layers keep the whole run within "
                 "about 600 s"),
        GRANITE_TRAIN: train(
            torch, dataclasses.replace(get_config(GRANITE_TRAIN),
                                       use_fused_kernels=True),
            GRANITE_TRAIN, steps=3, ckpt_every=None, replay_from=0, lr=3e-5,
            note="full width and depth; no checkpoint (the CPU tests hold "
                 "MoE checkpoints to the reference)")}
    # One entry per kernel, model, head dim and serving path that runs it;
    # launches are that path's burst's own counters, reset just before it.
    paths = []
    for m, fd in results["full_depth"].items():
        for mode, r in fd["serve"].items():
            paths.append((m, mode, r["launches"]))
        paths.append((m, "speculative", fd["spec_serve"]["launches"]))
        for mode, r in fd["quant_serve"].items():
            paths.append((m, f"quant_{mode}", r["launches"]))
        paths.append((m, "quant_speculative",
                      fd["quant_spec_serve"]["launches"]))
    for m, r in results["train"].items():
        paths.append((m, "train", r["launches"]))
    summary = []
    for kname in TPU_KERNELS:
        for model, path, launches in paths:
            # Kernel rows carry the unquantized path's tag: a whole prompt
            # or a verify dispatch has the same shapes under w8_kv8.
            base = path.removeprefix("quant_")
            mine = [r for r in rows if r["name"] == kname
                    and r["model"] == model and r["dtype"] == "bfloat16"
                    and r["path"] in (None, base)]
            if not launches.get(kname) or not mine:
                continue
            # The path's own shape where it has one (a whole prompt, a
            # verify dispatch), else the prefill-chunk / main decode shape.
            head = next((r for r in mine if r["path"] == base), mine[0])
            summary.append({
                "name": kname, "route": "cuda", "source": SOURCES[kname],
                "replaces": TPU_KERNELS[kname],
                "helper": kname in HELPERS, "model": model,
                "path": path, "head_dim": head["head_dim"],
                "launches": launches[kname],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "checks_ok": all(r["ok"] for r in rows
                                 if r["name"] == kname
                                 and r["model"] == model)})
    missing = sorted(set(TPU_KERNELS) - {e["name"] for e in summary})
    if missing:
        raise AssertionError(f"kernels no burst launched: {missing}")
    emit({"kernels": summary})
    results["kernels"] = summary
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro."))
                    or m == "repro")
    if leaked:
        raise AssertionError(f"the port pulled in {leaked}")
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
