#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, one JSON line each (numbers measured in this run, on this card):

1. device   — the card's name and power limit (nvidia-smi), then the build
              of every CUDA kernel with nvcc for sm_90a from ``csrc/``;
2. kernel   — each kernel against its plain PyTorch version at the main
              paths' shapes (llama3-8b and gpt2, gpt2's projections and
              MLP also at whole-prompt lengths, the projections, FFNs and
              the verify kernel also at a speculative verify dispatch of 4
              slots x 5 rows), in bfloat16 and float32: max error against
              the stated tolerance, kernel / plain / library times (CUDA
              events, L2 flushed between launches) and the card's bound;
              then two bit-for-bit checks: every row of the verify kernel
              equals the decode kernel at that row's length, and the
              projection and FFN kernels give a row the same bits at 4
              rows (decode) as at 8, 12 and 20 (verify windows of 2, 3
              and 5) — reported, not required, for the PyTorch calls on
              the same path (``torch.matmul`` at the o-projection and
              LM-head shapes, the eager norms);
3. fused_vs_eager — llama3-8b at full width cut to 4 layers, float32: one
              mixed burst through ``ServingEngine`` with the kernel plan and
              with the eager plan must give the same greedy tokens;
4. serve    — llama3-8b at full width and depth, bfloat16, random weights
              drawn on the card from a seed: a mixed burst of 8 prompts
              (37..1000 tokens, 32 new tokens each) through the paged,
              chunked-prefill engine (prefix cache on, its default); the
              launch counts during it must be > 0 for the llama3 kernels
              and 0 for the rest, and every request complete; the first
              prompt served alone must repeat its tokens from the burst;
5. gpt2_fused_vs_eager — gpt2 at full width cut to 4 layers, float32,
              jittered weights: the kernel plan and the eager plan must
              give the same greedy tokens, with chunked and with
              whole-prompt admission;
6. gpt2_serve — gpt2 at full width and depth, bfloat16, jittered weights
              drawn on the card: the same kind of burst (prompts up to 992
              tokens in its 1024-position context), once with chunked
              and once with whole-prompt admission, each with its own
              launch counts (chunked: block_matmul, streamed_mlp,
              flash_attention, paged_attention; whole-prompt: the static
              flash kernel instead of the offset one);
7. spec_fused_vs_eager — llama3-8b and gpt2 at full width cut to 4 layers,
              float32, on the speculative burst (8 prompts sharing a
              512-token prefix, two of them repeated verbatim, 32 new
              tokens each): the plain engine (no prefix cache), the
              default engine (prefix cache on), the speculative engine
              (draft_len 4) with the kernel plan and with the eager plan
              must all give the same greedy tokens;
8. spec_serve — llama3-8b and gpt2 at full width and depth, bfloat16, the
              speculative burst through the speculative engine with the
              prefix cache on: every request completes, the verify kernel
              launches and the decode kernel does not, prefix pages are
              hit and drafts rolled back; the same burst through the plain
              engine, with per-request token equality and first
              divergence reported;
9. kernels  — one line listing every kernel, once per model and serving
              path that runs it, with its check results and that path's
              own launch count.

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
}
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
}
# The kernels each serving path must launch; every other count must be 0.
LLAMA_PATH = {"rmsnorm_matmul", "streamed_ffn", "flash_attention",
              "paged_attention"}
GPT2_PATHS = {
    "chunked": {"block_matmul", "streamed_mlp", "flash_attention",
                "paged_attention"},
    "whole_prompt": {"block_matmul", "streamed_mlp",
                     "flash_attention_static", "paged_attention"},
}
# The speculative engine verifies every decode: K8, never K1.
SPEC_PATHS = {
    "llama3-8b": {"rmsnorm_matmul", "streamed_ffn", "flash_attention",
                  "paged_verify_attention"},
    "gpt2": {"block_matmul", "streamed_mlp", "flash_attention",
             "paged_verify_attention"},
}
# A verify dispatch: 4 slots x a 5-row window (draft_len 4); the window
# ladder's other rungs give 2 and 3 rows.
SLOTS, WINDOW = 4, 5
SPEC_T = SLOTS * WINDOW


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def _flash_case(torch, K, ref, randn, isz, name, hq, hkv, hd, sq, skv,
                q_off, dev):
    """A causal flash call and its SDPA yardstick: the offset branch over a
    gathered extent (``q_off`` set, kv_len = q_off + sq), or the static
    branch over a whole prompt (``q_off`` None, sq == skv)."""
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
    if q_off is None:
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
                nbytes=(2 * hq * sq * hd + 2 * hkv * kv_len * hd) * isz,
                flops=4 * hd * live_pairs)


def _paged_case(torch, K, ref, randn, isz, gen, hq, hkv, hd, maxp, dev):
    """Paged decode: 4 slots, ``maxp`` 16-token pages of capacity each."""
    b, ps = 4, 16
    pool_pages = 1 + b * maxp
    kp = randn(pool_pages, ps, hkv, hd)
    vp = randn(pool_pages, ps, hkv, hd)
    perm = torch.randperm(pool_pages - 1, generator=gen, device=dev) + 1
    table = perm[:b * maxp].reshape(b, maxp).to(torch.int32).contiguous()
    lens = [1000, 517, 37, 0]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = randn(b, 1, hq, hd)
    return dict(
        name="paged_attention", head_dim=hd,
        shape=f"B={b},Hq={hq},Hkv={hkv},D={hd},ps={ps},lengths={lens}",
        kernel=lambda: K.paged_decode_attention(qd, kp, vp, table, lengths),
        plain=lambda: ref.paged_decode_attention(qd, kp, vp, table, lengths),
        library=None, cublas=None,
        nbytes=(2 * b * hq * hd + 2 * sum(lens) * hkv * hd) * isz
        + (b * maxp + b) * 4,
        flops=4 * hd * hq * sum(lens))


def _verify_case(torch, K, ref, randn, isz, gen, hq, hkv, hd, maxp, dev):
    """Speculative verify: 4 slots, a 5-row window at offsets 1000, 517,
    37 and 0, ``maxp`` 16-token pages of capacity each.  The bytes are the
    live pages' K/V (through each slot's deepest row) plus q and out, as
    the decode kernel's; the operations count each row's own extent."""
    b, ps, w = SLOTS, 16, WINDOW
    pool_pages = 1 + b * maxp
    kp = randn(pool_pages, ps, hkv, hd)
    vp = randn(pool_pages, ps, hkv, hd)
    perm = torch.randperm(pool_pages - 1, generator=gen, device=dev) + 1
    table = perm[:b * maxp].reshape(b, maxp).to(torch.int32).contiguous()
    offs = [1000, 517, 37, 0]
    q_off = torch.tensor(offs, dtype=torch.int32, device=dev)
    qv = randn(b, w, hq, hd)
    rows = sum(o + i + 1 for o in offs for i in range(w))
    return dict(
        name="paged_verify_attention", head_dim=hd,
        shape=(f"B={b},W={w},Hq={hq},Hkv={hkv},D={hd},ps={ps},"
               f"q_off={offs}"),
        kernel=lambda: K.paged_verify_attention(qv, kp, vp, table, q_off),
        plain=lambda: ref.paged_verify_attention(qv, kp, vp, table, q_off),
        library=None, cublas=None,
        nbytes=(2 * b * w * hq * hd + 2 * sum(o + w for o in offs) * hkv * hd)
        * isz + (b * maxp + b) * 4,
        flops=4 * hd * hq * rows,
        rows_vs_decode=lambda out: [
            bool(torch.equal(out[:, i:i + 1], K.paged_decode_attention(
                qv[:, i:i + 1].contiguous(), kp, vp, table, q_off + i + 1)))
            for i in range(w)])


def kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """llama3-8b's kernel calls: name, shape label, kernel / plain /
    library call (one PyTorch call computing the same function, or None),
    a cuBLAS yardstick (the matmuls alone, on pre-normalised x, or None),
    and the bytes and operations the call needs."""
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

    # Offset flash attention: one 128-token chunk at offset 896 over the
    # slot's gathered 2048-position extent, 1024 of them live.
    cases.append(_flash_case(torch, K, ref, randn, isz, "flash_attention",
                             32, 8, 128, 128, 2048, 896, dev))
    cases.append(_paged_case(torch, K, ref, randn, isz, gen, 32, 8, 128, 128,
                             dev))
    cases.append(_verify_case(torch, K, ref, randn, isz, gen, 32, 8, 128, 128,
                              dev))
    return cases


def gpt2_kernel_cases(torch, K, ref, dtype, gen, dev="cuda"):
    """gpt2's kernel calls, as ``kernel_cases``: the three projections
    (K = N = 1024) and the MLP (D = 1024, F = 4096) at a prefill chunk, at
    decode, and at whole prompts of the serve burst's longest (992 rows)
    and shortest (37 rows: a partial tile, split K) lengths; attention at
    head dim 64 with 16 query and 16 KV heads.  ``path`` tags the cases
    only whole-prompt admission runs."""
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
    # A 128-token chunk at offset 896 over a 1024-position extent; the
    # whole-prompt branch over a 1000-token prompt.
    cases.append(_flash_case(torch, K, ref, randn, isz, "flash_attention",
                             16, 16, 64, 128, 1024, 896, dev))
    cases.append(_paged_case(torch, K, ref, randn, isz, gen, 16, 16, 64, 64,
                             dev))
    cases.append(_verify_case(torch, K, ref, randn, isz, gen, 16, 16, 64, 64,
                              dev))
    cases.append(_flash_case(torch, K, ref, randn, isz,
                             "flash_attention_static", 16, 16, 64, 1000,
                             1000, None, dev))
    return cases


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
        for c in cases:
            out = c["kernel"]()
            torch.cuda.synchronize()
            want = c["plain"]()
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
            emit(row)
            rows.append(row)
            if c["name"] == "paged_attention":
                zero = out[3].float().abs().max().item()
                if zero != 0.0:
                    raise AssertionError("paged_attention: a length-0 slot "
                                         f"gave |out| up to {zero}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("kernels disagree with their plain versions: "
                             + "; ".join(f"{r['name']} {r['dtype']} "
                                         f"{r['shape']} rel {r['rel_err']} "
                                         f"rows {r['rows_equal_decode']}"
                                         for r in bad))
    return rows


def check_row_invariance(torch):
    """Bit-for-bit: rows 0..3 of each projection and FFN kernel at T rows
    (8, 12, 20: verify windows of 2, 3 and 5 over 4 slots) against the
    same call at T = 4 (a decode step), at llama3's and gpt2's shapes, in
    bfloat16 and float32.  Exact acceptance needs the kernels to pass;
    the PyTorch calls on the same path (``torch.matmul`` at the
    o-projection and LM-head shapes, the eager norms) are reported beside
    them, not required."""
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
            calls = {"o_proj torch.matmul": lambda a: torch.matmul(a, w_o),
                     "lm_head torch.matmul": lambda a: torch.matmul(a, head)}
            # The eager norms on the path (llama3's final RMSNorm, gpt2's
            # LayerNorms): PyTorch reductions, also reported only.
            if model == "llama3-8b":
                calls["rms_norm torch"] = lambda a: L.rms_norm(a, s)
            else:
                calls["layer_norm torch"] = lambda a: L.layer_norm(a, s, s)
            if model == "llama3-8b":
                calls["rmsnorm_matmul N=4096"] = (
                    lambda a: K.rmsnorm_matmul(a, s, w_o))
                calls["rmsnorm_matmul N=1024"] = (
                    lambda a: K.rmsnorm_matmul(a, s, w_k))
                calls["streamed_ffn"] = (
                    lambda a: K.streamed_ffn(a, wg, wu, wd, norm_scale=s))
            else:
                calls["block_matmul"] = lambda a: K.block_matmul(a, w_k)
                calls["streamed_mlp"] = lambda a: K.streamed_mlp(a, wu, wd)
            for name, fn in calls.items():
                base = fn(x[:SLOTS].contiguous())
                same = {t: bool(torch.equal(fn(x[:t].contiguous())[:SLOTS],
                                            base))
                        for t in (2 * SLOTS, 3 * SLOTS, SPEC_T)}
                row = {"phase": "row_invariance", "model": model,
                       "dtype": dname, "call": name,
                       "equal_to_T4": same, "required": "torch" not in name}
                emit(row)
                out.append(row)
                if row["required"] and not all(same.values()):
                    bad.append(f"{model} {dname} {name} {same}")
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
    ({fused: tokens}, {fused: seconds})."""
    from repro_torch.serving import ServingEngine
    tokens, seconds = {}, {}
    for fused in (True, False):
        eng = ServingEngine(
            dataclasses.replace(cfg, use_fused_kernels=fused), params,
            batch_slots=4, max_len=512, chunked=chunked, device=device)
        t0 = time.perf_counter()
        reqs = eng.generate(prompts, max_new_tokens=8)
        _sync(torch, device)
        seconds[fused] = time.perf_counter() - t0
        tokens[fused] = [r.out_tokens for r in reqs]
    return tokens, seconds


def _free(torch, device):
    if device == "cuda":
        torch.cuda.empty_cache()


def fused_vs_eager(torch, cfg, device="cuda", lengths=(150, 40, 300, 9)):
    """``cfg``: llama3-8b cut to 4 layers, float32."""
    params = _weights(torch, cfg, 1, jitter=False, device=device)
    prompts = burst(np.random.default_rng(1), cfg.vocab_size, lengths)
    tokens, seconds = _fused_eager(torch, cfg, params, prompts, True,
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


def gpt2_fused_vs_eager(torch, cfg, device="cuda",
                        lengths=(150, 40, 300, 9)):
    """``cfg``: gpt2 cut to 4 layers, float32; jittered weights.  Fused and
    eager tokens must agree under each admission mode.  Whether chunked
    and whole-prompt tokens agree is reported, not required: the two sum
    attention in different orders."""
    params = _weights(torch, cfg, 1, jitter=True, device=device)
    prompts = burst(np.random.default_rng(1), cfg.vocab_size, lengths)
    row = {"phase": "gpt2_fused_vs_eager", "config": cfg.name,
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "prompts": [len(p) for p in prompts], "new_tokens": 8}
    fused_tokens = {}
    for mode, chunked in (("chunked", True), ("whole_prompt", False)):
        tokens, seconds = _fused_eager(torch, cfg, params, prompts, chunked,
                                       device)
        row[mode] = {"tokens_equal": tokens[True] == tokens[False],
                     "fused_s": seconds[True], "eager_s": seconds[False],
                     "fused_tokens": tokens[True],
                     "eager_tokens": tokens[False]}
        fused_tokens[mode] = tokens[True]
    row["chunked_equals_whole_prompt"] = (fused_tokens["chunked"]
                                          == fused_tokens["whole_prompt"])
    emit(row)
    del params
    _free(torch, device)
    bad = [m for m in GPT2_PATHS if not row[m]["tokens_equal"]]
    if bad:
        raise AssertionError(f"gpt2 fused and eager plans gave different "
                             f"greedy tokens under {bad} admission")
    return row


def serve(torch, cfg, params, expect, *, init_s, chunked=True,
          phase="serve", device="cuda", max_len=2048, lo=37, hi=1000,
          new=32):
    """A mixed burst of 8 prompts through the engine with the kernel plan;
    the kernels in ``expect`` must each launch, and no other."""
    from repro_torch import kernels as K
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import COUNTER_NAMES
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
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
           "layers": cfg.num_layers, "dtype": cfg.dtype,
           "admission": "chunked" if chunked else "whole_prompt",
           "weight_bytes": weight_bytes, "init_s": init_s,
           "slots": 4, "max_len": max_len, "prompt_lengths": lengths,
           "new_tokens": new, "wall_s": wall, "generated": generated,
           "tokens_per_s": generated / wall,
           "ttft_p50_s": statistics.median(ttft),
           "ttft_max_s": max(ttft),
           "tpot_mean_ms": 1e3 * statistics.mean(tpot),
           "kv_bytes_peak": eng.metrics["kv_bytes_peak"],
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


def serve_llama(torch, cfg, device="cuda"):
    """``cfg``: llama3-8b at full width and depth, bfloat16, kernel plan."""
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=False, device=device)
    _sync(torch, device)
    row = serve(torch, cfg, params, LLAMA_PATH,
                init_s=time.perf_counter() - t0, device=device)
    del params
    _free(torch, device)
    return row


def serve_gpt2(torch, cfg, device="cuda"):
    """``cfg``: gpt2 at full width and depth, bfloat16, kernel plan; one
    burst per admission mode, each with its own launch counts.  gpt2's
    context is 1024 positions, so prompts stop at 1024 - 32 = 992 tokens
    for every request to get its 32 new tokens."""
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=True, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
    rows = {mode: serve(torch, cfg, params, GPT2_PATHS[mode], init_s=init_s,
                        chunked=mode == "chunked", phase="gpt2_serve",
                        device=device, max_len=1024, hi=992)
            for mode in ("chunked", "whole_prompt")}
    del params
    _free(torch, device)
    return rows


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


def spec_fused_vs_eager(torch, cfg, *, jitter, max_len, device="cuda",
                        new=32):
    """``cfg``: full width cut to 4 layers, float32, kernel plan.  The four
    engines of ``SPEC_ENGINES`` must give the same greedy tokens on the
    speculative burst."""
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
        t0 = time.perf_counter()
        reqs = eng.generate(prompts, max_new_tokens=new)
        _sync(torch, device)
        tokens[name] = [r.out_tokens for r in reqs]
        m = eng.metrics
        row[name] = {"seconds": time.perf_counter() - t0,
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
    return row


def spec_serve(torch, cfg, expect, *, jitter, max_len, device="cuda",
               new=32):
    """``cfg``: full width and depth, bfloat16, kernel plan.  The
    speculative burst through the speculative engine (prefix cache on),
    then through the plain engine for per-request token equality."""
    from repro_torch import kernels as K
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import COUNTER_NAMES
    t0 = time.perf_counter()
    params = _weights(torch, cfg, 2, jitter=jitter, device=device)
    _sync(torch, device)
    init_s = time.perf_counter() - t0
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
    generated = sum(len(r.out_tokens) for r in reqs)
    ttft = [r.ttft_s for r in reqs]
    tpot = [r.tpot_s for r in reqs]
    bm = burst_metrics
    row = {"phase": "spec_serve", "config": cfg.name,
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
           "first_divergence": [_first_divergence(r.out_tokens, b)
                                for r, b in zip(reqs, base)]}
    emit(row)
    del params
    _free(torch, device)
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
    if problems:
        raise AssertionError(f"spec_serve {cfg.name}: " + "; ".join(problems))
    return row


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "nvcc": _build.find_nvcc()})
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as fh:
        for n, log in _build.BUILD_LOG.items():
            fh.write(f"== {n}\n{log}\n")

    from repro_torch.configs import get_config
    llama, gpt2 = get_config("llama3-8b"), get_config("gpt2")
    results = {"device": smi, "name": name}
    rows = check_kernels(torch, Timer(torch))
    results["kernel_checks"] = rows
    results["row_invariance"] = check_row_invariance(torch)
    results["fused_vs_eager"] = fused_vs_eager(
        torch, dataclasses.replace(llama, num_layers=4, dtype="float32"))
    results["serve"] = serve_llama(
        torch, dataclasses.replace(llama, use_fused_kernels=True))
    results["gpt2_fused_vs_eager"] = gpt2_fused_vs_eager(
        torch, dataclasses.replace(gpt2, num_layers=4, dtype="float32"))
    results["gpt2_serve"] = serve_gpt2(
        torch, dataclasses.replace(gpt2, use_fused_kernels=True))
    models = {"llama3-8b": (llama, False, 2048), "gpt2": (gpt2, True, 1024)}
    results["spec_fused_vs_eager"] = {
        m: spec_fused_vs_eager(
            torch, dataclasses.replace(c, num_layers=4, dtype="float32",
                                       use_fused_kernels=True),
            jitter=jit, max_len=ml)
        for m, (c, jit, ml) in models.items()}
    results["spec_serve"] = {
        m: spec_serve(torch, dataclasses.replace(c, use_fused_kernels=True),
                      SPEC_PATHS[m], jitter=jit, max_len=ml)
        for m, (c, jit, ml) in models.items()}
    # One entry per kernel, model, head dim and serving path that runs it;
    # launches are that path's burst's own counters, reset just before it.
    paths = [("llama3-8b", "chunked", LLAMA_PATH,
              results["serve"]["launches"])]
    paths += [("gpt2", mode, GPT2_PATHS[mode], r["launches"])
              for mode, r in results["gpt2_serve"].items()]
    paths += [(m, "speculative", SPEC_PATHS[m], r["launches"])
              for m, r in results["spec_serve"].items()]
    summary = []
    for kname in TPU_KERNELS:
        for model, path, expect, launches in paths:
            mine = [r for r in rows if r["name"] == kname
                    and r["model"] == model and r["dtype"] == "bfloat16"
                    and r["path"] in (None, path)]
            if kname not in expect or not mine:
                continue
            # The path's own shape where it has one (a whole prompt, a
            # verify dispatch), else the prefill-chunk / main decode shape.
            head = next((r for r in mine if r["path"] == path), mine[0])
            summary.append({
                "name": kname, "route": "cuda", "source": SOURCES[kname],
                "replaces": TPU_KERNELS[kname], "model": model,
                "path": path, "head_dim": head["head_dim"],
                "launches": launches[kname],
                "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "shape": head["shape"],
                "checks_ok": all(r["ok"] for r in rows
                                 if r["name"] == kname
                                 and r["model"] == model)})
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
