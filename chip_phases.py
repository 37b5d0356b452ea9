#!/usr/bin/env python3
"""Single phases of ``chip_smoke.py`` on one card, building only the
kernel sources they need; each result is one JSON line on stdout.

    python3 chip_phases.py [--tree DIR] PHASE [PHASE ...]

``--tree`` imports ``repro_torch`` and ``chip_smoke`` from another checkout
(say the parent commit unpacked into ``build/parent``) so that two trees
can be compared in one call on one card: run parent, change, change,
parent.  Phases:

  k5_hashes  sha256 of K5's bf16 outputs (``block_matmul``) at the
             ``tensorcore`` phase's (M, K, N) shapes, from seeded inputs:
             equal hashes on two trees mean bit-equal outputs;
  norm       K3 and K10a (``rmsnorm_matmul``, ``_w8``) in bf16 at 1..4096
             rows at each path's (D, N), and their rows at 1..64 rows;
  xent       K11 (``streamed_xent_parts``) in bf16 at the training shapes;
  ffn_hashes sha256 of the six bf16 FFN instances' outputs (K4, K6,
             K10b, K10c: ``streamed_ffn``, ``_w8``, ``streamed_mlp``,
             ``_w8``) at this checkout's ``tensorcore`` shapes
             (``TC_FFN_*``), from seeded inputs;
  moe        sha256 of K12's (``moe_experts``) float32 and bf16 outputs at
             this checkout's ``tensorcore`` cases (``chip_smoke._moe_cases``:
             both granite widths, the router's gates and the adversarial
             routings; equal float32 hashes on two trees: bit-equal
             outputs);
  moe_probe  where K12's bf16 time goes at granite-3b's widths: a plain
             16-byte-load read of all 40 experts' weights (189 MB) in the
             fused launch's block slices and in contiguous chunks (the
             card's read rate for those bytes), then K12 and the library
             chain at 4, 20, 128 and 1000 tokens (router gates): CUDA-event
             times and each kernel's device time (``torch.profiler``);
  tensorcore, kernel, row_invariance
             those phases of ``chip_smoke.py`` whole;
  burst      llama3-8b at full width, ``SERVE_LAYERS`` deep, bf16: the
             chunked mixed burst (``chip_smoke.serve``), then the same
             burst through a
             fresh engine under ``torch.profiler`` (this checkout's
             ``chip_smoke.profile_burst``, on the tree's engine): device ms
             by stage, busy, wall and idle share;
  granite_burst
             granite-moe-3b at full width, ``SERVE_LAYERS`` deep, bf16:
             as ``burst``;
  train      llama3-8b at full width, 2 layers: ``chip_smoke.train``'s
             3 steps with a profiled step;
  granite_train
             granite-moe-1b at full width and depth: the same;
  flash_q_hashes
             sha256 of K9c's (``flash_attention_2d_q``) float32 outputs
             at this checkout's ``tensorcore`` shapes (``TC_OFFSET_*``,
             int8 and fp8), from seeded inputs;
  ssd_hashes sha256 of K13's (``mamba2_ssd``) float32 y and final state at
             this checkout's ``tensorcore`` shapes (``TC_SSD_S`` and 2 x
             2048, the model's chunk), from seeded inputs;
  flash_q, ssd
             this checkout's bf16 ``tensorcore`` rows of K9c
             (``_flash_q_tc_rows``) and K13 (``_ssd_tc_rows``) on the
             tree's kernels, with their bit-for-bit checks (reported, not
             required: an older tree's kernels need not meet them);
  zamba_burst
             zamba2-2.7b at full size, bf16: the whole-prompt mixed burst
             (TTFT, TPOT) and the same burst under ``torch.profiler``, as
             ``burst``;
  quant_burst
             llama3-8b at full width, ``SERVE_LAYERS`` deep, bf16,
             ``w8_kv8``: the chunked mixed burst, as ``burst``;
  wkv_hashes sha256 of K14's (``wkv6``) float32 y and final state at this
             checkout's ``tensorcore`` shapes (``TC_WKV_S`` and 2 x 2048,
             the model's chunk), from seeded inputs;
  wkv        this checkout's bf16 ``tensorcore`` rows of K14
             (``_wkv_tc_rows``) on the tree's kernels, with its bit-for-bit
             checks (reported, not required);
  rwkv_burst rwkv6-7b at full size, bf16, jittered: the whole-prompt mixed
             burst (TTFT, TPOT) and the same burst under ``torch.profiler``,
             as ``burst``;
  convert    the tree's ``compile`` phase: every compiled edge through K15,
             checked and timed (``chip_smoke.compile_path``);
  wkv_probe  K14's bf16 launches by device time (``torch.profiler``, the
             L2 rewritten before each call) at this checkout's
             ``tensorcore`` shapes, beside the call's CUDA-event time and,
             for scale, the eager ``wkv6_chunked``'s (chunk 16; it clamps
             each log decay at -5, so it computes another function);
  convert_probe
             K15's device time on every edge of this checkout's compiled
             blocks (``COMPILE_MODELS`` at 128 tokens and ``COMPILE_LONG``)
             in bf16, free of the host time the event timer can catch on
             streams of a few microseconds;
  qwen_kernel_cases
             the Qwen paths' kernel rows (``chip_smoke.qwen_kernel_cases``,
             bf16 and float32, against their plain versions) and their
             rows at 1..64 rows (``check_qwen_rows``);
  qwen_fused_vs_eager, qwen_serve
             those phases of ``chip_smoke.py`` for qwen3-0.6b, qwen1.5-0.5b
             and qwen2-vl-2b;
  qwen_train qwen3-0.6b and qwen2-vl-2b at full width and depth:
             ``chip_smoke.train``'s 3 steps with a profiled step;
  gemma_kernel_cases
             gemma3-4b's kernel rows (``chip_smoke.gemma_kernel_cases``,
             bf16 and float32, against their plain versions: head dim
             320, the 1024-token window and none), then
             ``check_gemma_rows`` (K3 and K4 rows at 1..64 rows, K2's
             chunk rows equal to K7's, the local / global K7 times);
  gemma_fused_vs_eager, gemma_serve, gemma_quant_fused_vs_eager,
  gemma_quant_serve
             those phases of ``chip_smoke.py`` for gemma3-4b (the last two
             its quantized serving: every quant mode at 6 layers in
             float32, then ``w8_kv8``'s bursts);
  flash_hashes
             sha256 of the causal flash kernels' bf16 and float32 outputs
             (K7, K2, K9c over int8 and fp8) at this checkout's
             ``tensorcore`` shapes (``TC_FLASH_*``, ``TC_OFFSET_*``,
             ``TC_OFFSET_Q_*``) and at gemma3's head dim 320 with its
             window and without, from seeded inputs: equal hashes on two
             trees mean bit-equal outputs;
  flash_times
             the causal K7, K2 and K9c calls of the paths (``FLASH_TIMES``)
             timed in bf16 and float32, for parent/change comparisons;
  paged_hashes
             sha256 of K1's, K8's, K9a's and K9b's bf16 and float32
             outputs over the ``paged_split`` slots at head dims 64, 80
             (decode), 128 and 320, GQA 1 and 4, every pool type, with and
             without a window, from seeded inputs;
  hubert_kernel_cases
             hubert-xlarge's kernel rows (``chip_smoke.hubert_kernel_cases``:
             K5, K6, non-causal K7 and K11 at the encode's and a training
             step's shapes, bf16 and float32, against their plain
             versions);
  hubert_fused_vs_eager, hubert_encode
             those phases of ``chip_smoke.py``;
  hubert_train
             hubert-xlarge at full width cut to ``HUBERT_TRAIN_LAYERS``
             (``chip_smoke.hubert_train``): 3 steps, the step-2
             checkpoint and the replay of step 3;
  train_kernel_cases
             the training paths' kernel rows (``chip_smoke.train_cases``:
             llama3-8b's, gpt2's and gemma3-4b's at a step's tokens, the
             int8 twins K10a / K10b / K10c among them, gemma3's K7 at head
             dim 320 and K11 over its 262144-token vocabulary), bf16 and
             float32, against their plain versions;
  gemma_train_fused_vs_eager, train_w8_ste, gemma_train, quant_train
             those phases of ``chip_smoke.py``: gemma3-4b's float32
             kernel-plan step against its eager step at 6 layers, the
             straight-through identity under w8 (llama3-8b at 4 layers,
             gemma3-4b at 6), gemma3-4b's bf16 training at 6 layers, and
             the w8 training entries (gemma3-4b at 6 layers, llama3-8b at
             2, gpt2 at full depth);
  serve_contiguous, serve_surface, serve_launcher
             those phases of ``chip_smoke.py``: llama3-8b's mixed burst
             through the contiguous slot cache beside the paged
             whole-prompt engine; the surface's kernel rows and float32
             bursts (page sizes, chunks, layouts, adaptive decode block,
             contiguous); ``python -m repro_torch.launch.serve``
             in-process.
  serve_pages, plan_verify
             those phases of ``chip_smoke.py``: gpt2's bursts over the
             compiler's 10-token pages and 130-token chunks at ``max_len``
             1000 beside 16 and 128 at 1024 (the kernel rows over the new
             granules, tokens, launches, a seeded plan refused); every
             registry config's H100 plans (and the plans the phases run
             before it in the same call built) verified for the card, and
             each stage's kernels' shared memory profiled against the
             lint's count (it builds every source);
  tune_roundtrip, tune_serve
             those phases of ``chip_smoke.py``: the autotuner's round
             trip on gpt2 at full size (bf16 and float32), and
             llama3-8b's tuning pass and chunked burst untuned and tuned
             at ``SERVE_LAYERS``;
  serve_telemetry, obs_demo
             those phases of ``chip_smoke.py``: llama3-8b's chunked burst
             at ``SERVE_LAYERS`` with telemetry off and on (tokens,
             launches, events, trace, histograms; the trace goes to
             ``--out``); ``python -m repro_torch.obs --demo`` in-process
             (its files under ``--out``/obs_demo).
  dryrun, examples
             those phases of ``chip_smoke.py``: ``python -m
             repro_torch.launch.dryrun --all`` in-process (every cell's
             plan clean for the CUDA builds; the records under
             ``--out``/dryrun), the argument bytes against the card's
             allocator and one decode step of the sizing cell (the
             training peak's ratio needs ``chip_smoke.py``'s ``train``
             phase and is not measured here); each ``examples/torch_*.py``
             in-process (its OK line, its launches, the quickstart's K4
             and K7 within ``TOL``).

The card's name and power limit (nvidia-smi) come first.  ``--ptxas
FILE`` writes nvcc's resource report (``-Xptxas -v``: registers, shared
memory, spills per kernel) of the sources built to FILE; ``--out DIR``
(default ``build/chip_phases/``) holds the files a phase writes.  A
source the tree does not have is not built for it.  The phases of
the tree's own ``chip_smoke.py`` are used (``ffn_hashes``, ``moe`` and
``moe_probe`` take their shapes and inputs from this checkout's), so a
phase that an older tree lacks (norm, xent) runs only on trees that have
it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = {"k5_hashes": ["block_matmul"],
           "ffn_hashes": ["streamed_ffn", "streamed_ffn_w8"],
           "norm": ["rmsnorm_matmul"],
           "xent": ["streamed_xent"],
           "burst": ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                     "flash_attention", "paged_attention", "block_matmul"],
           "train": ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                     "flash_attention", "block_matmul", "streamed_xent"],
           "moe": ["moe_experts"], "moe_probe": ["moe_experts"],
           "granite_burst": ["rmsnorm_matmul", "flash_mma", "flash_attention",
                             "paged_attention_64", "block_matmul",
                             "row_norm", "moe_experts"],
           "granite_train": ["rmsnorm_matmul", "flash_mma", "flash_attention",
                             "block_matmul", "streamed_xent", "row_norm",
                             "moe_experts"],
           "flash_q_hashes": ["flash_attention"],
           "flash_q": ["flash_mma", "flash_attention"],
           "ssd_hashes": ["mamba2_scan"], "ssd": ["mamba2_scan"],
           "zamba_burst": ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                           "flash_attention", "paged_attention_80",
                           "block_matmul", "row_norm", "mamba2_scan"],
           "quant_burst": ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                           "flash_attention", "paged_attention",
                           "block_matmul", "streamed_ffn_w8"],
           "wkv_hashes": ["rwkv6_wkv"], "wkv": ["rwkv6_wkv"],
           "rwkv_burst": ["rwkv6_wkv", "row_norm", "block_matmul"],
           "convert": ["stream_converter"], "wkv_probe": ["rwkv6_wkv"],
           "convert_probe": ["stream_converter"]}
QWEN_SOURCES = ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                "flash_attention", "paged_attention", "paged_attention_64",
                "block_matmul", "streamed_ffn_w8", "streamed_xent"]
SOURCES.update(dict.fromkeys(("qwen_kernel_cases", "qwen_fused_vs_eager",
                              "qwen_serve", "qwen_train"), QWEN_SOURCES))
SOURCES.update(dict.fromkeys(("gemma_kernel_cases", "gemma_fused_vs_eager",
                              "gemma_serve", "gemma_quant_fused_vs_eager",
                              "gemma_quant_serve"),
                             QWEN_SOURCES[:-1] + ["paged_attention_320",
                                                  "paged_attention_q320"]))
SOURCES.update(dict.fromkeys(("hubert_kernel_cases", "hubert_fused_vs_eager",
                              "hubert_encode", "hubert_train"),
                             ["block_matmul", "streamed_ffn", "flash_mma",
                              "flash_attention", "streamed_xent"]))
SOURCES["flash_hashes"] = SOURCES["flash_times"] = ["flash_mma",
                                                    "flash_attention"]
# The training phases: the kernel plan's training path under w8 too.
TRAIN_SOURCES = ["rmsnorm_matmul", "streamed_ffn", "streamed_ffn_w8",
                 "flash_mma", "flash_attention", "block_matmul",
                 "streamed_xent"]
SOURCES.update(dict.fromkeys(("train_kernel_cases",
                              "gemma_train_fused_vs_eager", "train_w8_ste",
                              "gemma_train", "quant_train"), TRAIN_SOURCES))
SOURCES["paged_hashes"] = ["paged_attention", "paged_attention_64",
                           "paged_attention_80", "paged_attention_320",
                           "paged_attention_q320"]
# The engine's surface: llama3-8b's serving kernels; the launcher also
# gpt2's (head dim 64, its MLP and LayerNorm rows).
SERVE_SOURCES = ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                 "flash_attention", "paged_attention", "block_matmul"]
SOURCES.update(dict.fromkeys(("serve_contiguous", "serve_surface"),
                             SERVE_SOURCES))
SOURCES["serve_launcher"] = SERVE_SOURCES + ["paged_attention_64",
                                             "row_norm"]
SOURCES["serve_telemetry"] = SERVE_SOURCES
# gpt2's paths at head dim 64 and llama3-8b's attention at 128 (the kernel
# rows over 10-token pages), zamba2's SSD scan (the seeded plan);
# plan_verify, absent here, builds every source.
SOURCES["serve_pages"] = ["block_matmul", "streamed_ffn", "flash_mma",
                          "flash_attention", "paged_attention",
                          "paged_attention_64", "row_norm", "mamba2_scan"]
# gpt2's speculative path: K5, K6, K2, K8 at head dim 64, the row norm.
SOURCES["obs_demo"] = ["block_matmul", "streamed_ffn", "flash_mma",
                       "flash_attention", "paged_attention_64", "row_norm"]
# The tuner's drivers time the LM-head loss (K11) beside the serving path.
SOURCES["tune_roundtrip"] = SOURCES["obs_demo"] + ["streamed_xent"]
SOURCES["tune_serve"] = SERVE_SOURCES + ["streamed_xent"]
# The dry-run launches nothing; the quickstart K4 and K7 in float32.
SOURCES["dryrun"] = []
SOURCES["examples"] = ["streamed_ffn", "flash_attention"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def this_chip_smoke():
    """This checkout's ``chip_smoke.py``, whichever tree ``--tree`` picks, so
    that both trees' profiles sort kernels into the same stages."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k5_hashes(torch, K, cs):
    """K5 at the tree's ``tensorcore`` shapes (``TC_MATMUL_*``)."""
    out = {}
    for k, n in cs.TC_MATMUL_KN:
        for m in cs.TC_MATMUL_M:
            gen = torch.Generator(device="cuda").manual_seed(
                m * 1_000_003 + k * 1009 + n)
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            w = (torch.randn(k, n, generator=gen, device="cuda")
                 / k ** 0.5).bfloat16()
            y = K.block_matmul(x, w)
            torch.cuda.synchronize()
            out[f"M={m},K={k},N={n}"] = hashlib.sha256(
                y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    emit({"phase": "k5_hashes", "hashes": out})


def _sha(torch, y):
    """sha256 of a bf16 or float32 tensor's bits."""
    view = torch.int16 if y.dtype == torch.bfloat16 else torch.int32
    return hashlib.sha256(y.view(view).cpu().numpy().tobytes()).hexdigest()


def ffn_hashes(torch, K, ref):
    """The FFN instances at this checkout's ``tensorcore`` shapes."""
    here, out = this_chip_smoke(), {}
    widths = [(here.TC_FFN_WIDTHS[m], here.TC_FFN_T)
              for m in here.TC_FFN_WIDTHS] + [here.TC_FFN_UNALIGNED]
    for (d, f), ts in widths:
        gen = torch.Generator(device="cuda").manual_seed(d * 1009 + f)
        randn = here._randn(torch, gen, torch.bfloat16, "cuda")
        insts = here._ffn_instances(torch, K, ref, randn, d, f)
        for name, (model, _, kern, _, _, _) in insts.items():
            if (d, f) != here.TC_FFN_UNALIGNED[0] and (
                    here.TC_FFN_WIDTHS[model] != (d, f)):
                continue
            for t in ts:
                x = randn(t, d)
                out[f"{name} T={t},D={d},F={f}"] = _sha(torch, kern(x))
    emit({"phase": "ffn_hashes", "hashes": out})


def moe(torch, K):
    """K12 on the tree at this checkout's ``tensorcore`` cases."""
    here, out = this_chip_smoke(), {}
    for dtype in (torch.float32, torch.bfloat16):
        for model, routing, t, x, g, wg, wu, wd in here._moe_cases(torch,
                                                                  dtype):
            out[f"{model} {routing} T={t} {str(dtype)[6:]}"] = _sha(
                torch, K.moe_experts(x, g, wg, wu, wd))
    emit({"phase": "moe_hashes", "hashes": out})


# A plain-load read of K12's weights, built by ``moe_probe`` alone: block
# (r, e) reads expert e's F columns [r FR, (r + 1) FR) of wg and wu over
# every D row and its wd rows [r FR, (r + 1) FR) (the fused launch's block
# slices), or a contiguous 1 / gridDim.x of each of its three matrices; 16-
# byte loads, four in flight per thread, folded into a sink so that none
# is dropped.
PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ unsigned read_run(const uint4* p, size_t n) {
  unsigned acc = 0;
  for (size_t i = threadIdx.x; i < n; i += 4 * 256) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = i + u * 256 < n ? __ldcs(p + i + u * 256) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  return acc;
}
__global__ void __launch_bounds__(256)
moe_read_probe(const char* wg, const char* wu, const char* wd, int d, int f,
               int fr, int contiguous, unsigned* sink) {
  const int e = blockIdx.y, r = blockIdx.x;
  const size_t mat = (size_t)d * f * 2;
  const char* w[3] = {wg + e * mat, wu + e * mat, wd + e * mat};
  unsigned acc = 0;
  if (contiguous) {
    const size_t chunk = mat / gridDim.x;
    for (int m = 0; m < 3; ++m)
      acc ^= read_run(reinterpret_cast<const uint4*>(w[m] + r * chunk),
                      chunk / 16);
  } else {
    const int vpr = fr * 2 / 16, rows = 256 / vpr;
    for (int m = 0; m < 2; ++m) {
      const char* base = w[m] + (size_t)r * fr * 2;
      for (int row = threadIdx.x / vpr; row < d; row += 4 * rows) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int rr = row + u * rows;
          v[u] = rr < d ? __ldcs(reinterpret_cast<const uint4*>(
                              base + (size_t)rr * f * 2) + threadIdx.x % vpr)
                        : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
      }
    }
    acc ^= read_run(reinterpret_cast<const uint4*>(
                        w[2] + (size_t)r * fr * d * 2), (size_t)fr * d * 2 / 16);
  }
  if (acc == 0x9e3779b9u) sink[0] = acc;
}
extern "C" int repro_moe_read_probe(const void* wg, const void* wu,
                                    const void* wd, int d, int f, int e,
                                    int fr, int contiguous, void* sink,
                                    void* stream) {
  moe_read_probe<<<dim3(f / fr, e), 256, 0, (cudaStream_t)stream>>>(
      (const char*)wg, (const char*)wu, (const char*)wd, d, f, fr,
      contiguous, (unsigned*)sink);
  return (int)cudaGetLastError();
}
"""


def _kernel_ms(torch, timer, fn, iters=10):
    """Each kernel's mean device milliseconds per ``fn()`` over ``iters``
    calls, the L2 rewritten before each (the timer's buffer; its fill
    kernel left out), by name up to its argument list."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    ms: dict = {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != cuda or "FillFunctor" in name:
            continue
        key = name.split("(repro::")[0].replace("void ", "")[:100]
        ms[key] = ms.get(key, 0.0) + e.duration_ns() / 1e6 / iters
    return ms


def moe_probe(torch, timer):
    """K12's bf16 time at granite-3b's widths beside a plain read of its
    weights."""
    import ctypes
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    here = this_chip_smoke()
    d, f, e = here.TC_MOE_WIDTHS[here.GRANITE]
    src = os.path.join(_build.BUILD_DIR, "moe_read_probe.cu")
    lib = os.path.join(_build.BUILD_DIR, "moe_read_probe.so")
    with open(src, "w") as fh:
        fh.write(PROBE_SRC)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    probe = ctypes.CDLL(lib).repro_moe_read_probe
    probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 2
    gen = torch.Generator(device="cuda").manual_seed(24)
    randn = here._randn(torch, gen, torch.bfloat16, "cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    nbytes = 3 * e * d * f * 2
    for t in (4, 20, 128, 1000):
        x, _, g, wg, wu, wd = here._moe_inputs(torch, randn, t, d, f, e,
                                               here.TC_MOE_TOP_K,
                                               torch.bfloat16)
        if t == 4:
            for contiguous in (0, 1):
                def read(c=contiguous):
                    status = probe(wg.data_ptr(), wu.data_ptr(),
                                   wd.data_ptr(), d, f, e, 128, c,
                                   sink.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
                    assert status == 0, status
                ms = timer(read)
                emit({"phase": "moe_probe", "read": ("block slices",
                                                     "contiguous")[contiguous],
                      "bytes": nbytes, "ms": ms,
                      "TB/s": nbytes / ms / 1e9})
        kept = g != 0
        for name, fn in (("moe_experts",
                          lambda: K.moe_experts(x, g, wg, wu, wd)),
                         ("library chain", lambda: here._moe_library(
                             torch, x, g, wg, wu, wd))):
            emit({"phase": "moe_probe", "call": name, "T": t,
                  "experts_touched": int(kept.any(0).sum()),
                  "gate_pairs": int(kept.sum()), "ms": timer(fn),
                  "kernel_ms": _kernel_ms(torch, timer, fn)})


def flash_q_hashes(torch, K):
    """K9c in float32 at this checkout's ``tensorcore`` shapes."""
    here, out = this_chip_smoke(), {}
    for code in here.CODES:
        for d, g in here.TC_OFFSET_Q_DG:
            for q_off in here.TC_OFFSET_Q:
                for sq in here.TC_OFFSET_ROWS:
                    skv = here.page_extent(q_off + sq)
                    gen = torch.Generator(device="cuda").manual_seed(
                        q_off * 1009 + sq * 31 + d + g)
                    randn = here._randn(torch, gen, torch.float32, "cuda")
                    q = randn(2 * g, sq, d)
                    (k, ks), (v, vs) = (here._encode(torch, randn(2, skv, d),
                                                     code, 1)
                                        for _ in range(2))
                    y = K.flash_attention_2d_q(
                        q, k, v, k_scale=ks, v_scale=vs, q_offset=q_off,
                        kv_len=q_off + sq, kv_group=g)
                    out[f"{code} D={d},G={g},q_offset={q_off},rows={sq}"] = (
                        _sha(torch, y))
    emit({"phase": "flash_q_hashes", "hashes": out})


def paged_hashes(torch, K):
    """K1, K8, K9a and K9b in bf16 and float32 over this checkout's
    ``paged_split`` slots (lengths at the page, tile and partition edges),
    head dims 64, 80 (decode only), 128 and 320, GQA groups 1 and 4, full-
    precision, int8 and fp8 pools, with no window and a 100-token one: the
    sha256 of each output, from seeded inputs (equal hashes on two trees:
    bit-equal outputs)."""
    from repro_torch.kernels.common import PAGED_PART
    here, out = this_chip_smoke(), {}
    ps, maxp = 16, here.SPLIT_MAXP
    extent = maxp * ps
    lens = [0, 1, 15, 16, 17, PAGED_PART - 1, PAGED_PART, PAGED_PART + 1,
            extent]
    b, hkv = len(lens), here.SPLIT_HKV
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]
        for d in (64, 80, 128, 320):
            for g in (1, 4):
                for code in (None,) + here.CODES:
                    for w in ((1,) if d == 80 else (1, 5)):
                        gen = torch.Generator(device="cuda").manual_seed(
                            d * 1009 + g * 31 + w)
                        randn = here._randn(torch, gen, dtype, "cuda")
                        kp, vp, sc, table, _ = here._paged_pools(
                            torch, randn, gen, b, maxp, hkv, d, code, "cuda")
                        q = randn(b, w, hkv * g, d)
                        base = (lens if w == 1 else
                                [n - 1 for n in lens[:-1]] + [extent - w])
                        bt = torch.tensor(base, dtype=torch.int32,
                                          device="cuda")
                        fn = {(1, None): K.paged_decode_attention,
                              (5, None): K.paged_verify_attention}.get(
                            (w, code)) or (K.paged_decode_attention_q
                                           if w == 1 else
                                           K.paged_verify_attention_q)
                        for window in (0, 100):
                            out[f"{fn.__name__} {dn} D={d},G={g},W={w},"
                                f"codes={code},window={window}"] = _sha(
                                torch, fn(q, kp, vp, table, bt, **sc,
                                          window=window))
    emit({"phase": "paged_hashes", "hashes": out})


def flash_hashes(torch, K):
    """K7, K2 and K9c, causal, in bf16 and float32 at this checkout's
    ``tensorcore`` shapes and gemma3's head dim 320 (the tree's kernels
    with their default, causal, masking)."""
    here, out = this_chip_smoke(), {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype)[6:]

        def inputs(seed, *shapes):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            randn = here._randn(torch, gen, dtype, "cuda")
            return [randn(*sh) for sh in shapes]

        for s in here.TC_FLASH_S:
            for d in here.TC_FLASH_D:
                for g in here.TC_FLASH_GROUPS:
                    q, k, v = inputs(s * 1009 + d * 31 + g, (2 * g, s, d),
                                     (2, s, d), (2, s, d))
                    out[f"K7 {dn} S={s},D={d},G={g}"] = _sha(
                        torch, K.flash_attention_2d(q, k, v, kv_group=g))
        for q_off in here.TC_OFFSET_Q:
            for sq in here.TC_OFFSET_ROWS:
                for d in here.TC_OFFSET_D:
                    for g in here.TC_OFFSET_GROUPS:
                        n = q_off + sq
                        q, k, v = inputs(q_off * 1009 + sq * 31 + d + g,
                                         (2 * g, sq, d), (2, n + 7, d),
                                         (2, n + 7, d))
                        out[f"K2 {dn} q_offset={q_off},rows={sq},D={d},"
                            f"G={g}"] = _sha(torch, K.flash_attention_2d(
                                q, k, v, q_offset=q_off, kv_len=n,
                                kv_group=g))
        for code in here.CODES:
            for d, g in here.TC_OFFSET_Q_DG:
                for q_off in here.TC_OFFSET_Q:
                    for sq in here.TC_OFFSET_ROWS:
                        skv = here.page_extent(q_off + sq)
                        gen = torch.Generator(device="cuda").manual_seed(
                            q_off * 1009 + sq * 31 + d + g)
                        randn = here._randn(torch, gen, dtype, "cuda")
                        q = randn(2 * g, sq, d)
                        (k, ks), (v, vs) = (
                            here._encode(torch, randn(2, skv, d).float(),
                                         code, 1) for _ in range(2))
                        out[f"K9c {dn} {code} D={d},G={g},q_offset={q_off},"
                            f"rows={sq}"] = _sha(torch, K.flash_attention_2d_q(
                                q, k, v, k_scale=ks, v_scale=vs,
                                q_offset=q_off, kv_len=q_off + sq,
                                kv_group=g))
        for window in (here.GEMMA_WINDOW, 0):
            q, k, v = inputs(320 + window, (8, 3000, 320), (4, 3000, 320),
                             (4, 3000, 320))
            out[f"K7 {dn} D=320,S=3000,window={window}"] = _sha(
                torch, K.flash_attention_2d(q, k, v, kv_group=2,
                                            window=window))
            for off in (896, 2872):
                out[f"K2 {dn} D=320,q_offset={off},window={window}"] = _sha(
                    torch, K.flash_attention_2d(
                        q[:, off:off + 128].contiguous(), k, v, q_offset=off,
                        kv_len=off + 128, kv_group=2, window=window))
    emit({"phase": "flash_hashes", "hashes": out})


# The causal flash calls of the paths, timed on each tree: (label, Hq,
# Hkv, D, Sq, Skv, q_offset or None for K7, K/V codes, window).
FLASH_TIMES = (
    ("K7 gpt2 whole prompt", 16, 16, 64, 1000, 1000, None, None, 0),
    ("K7 zamba2", 32, 32, 80, 1000, 1000, None, None, 0),
    ("K7 llama3 training", 64, 16, 128, 2048, 2048, None, None, 0),
    ("K7 gemma3 local", 8, 4, 320, 3000, 3000, None, None, 1024),
    ("K7 gemma3 global", 8, 4, 320, 3000, 3000, None, None, 0),
    ("K2 llama3 chunk", 32, 8, 128, 128, 1024, 896, None, 0),
    ("K2 gpt2 chunk", 16, 16, 64, 128, 1024, 896, None, 0),
    ("K2 gemma3 local chunk", 8, 4, 320, 128, 4096, 2944, None, 1024),
    ("K9c llama3 int8", 32, 8, 128, 128, 1024, 896, "int8", 0),
    ("K9c gpt2 fp8", 16, 16, 64, 128, 1024, 896, "fp8", 0),
)


def flash_times(torch, K, ref, timer):
    """CUDA-event times of the causal flash kernels at the paths' shapes
    (``FLASH_TIMES``) in bf16 and float32: this checkout's cases
    (``chip_smoke._flash_case``) on the tree's kernels."""
    here, out = this_chip_smoke(), {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device="cuda").manual_seed(31)
        randn = here._randn(torch, gen, dtype, "cuda")
        isz = torch.empty((), dtype=dtype).element_size()
        for label, hq, hkv, d, sq, skv, q_off, code, window in FLASH_TIMES:
            case = here._flash_case(torch, K, ref, randn, isz, label, hq, hkv,
                                    d, sq, skv, q_off, "cuda", code=code,
                                    window=window)
            out[f"{label} {str(dtype)[6:]}"] = timer(case["kernel"])
    emit({"phase": "flash_times", "ms": out})


def ssd_hashes(torch, K, ref):
    """K13 in float32 at this checkout's ``tensorcore`` shapes, the
    model's chunk."""
    here, out = this_chip_smoke(), {}
    for b, s in [(1, s) for s in here.TC_SSD_S] + [here.TRAIN_SHAPES[
            here.ZAMBA]]:
        gen = torch.Generator(device="cuda").manual_seed(b * 100_003 + s)
        randn = here._randn(torch, gen, torch.float32, "cuda")
        y, state = here._ssd_case(torch, K, ref, randn, 4, b, s,
                                  None)["kernel"]()
        out[f"B={b},S={s}"] = [_sha(torch, y), _sha(torch, state)]
    emit({"phase": "ssd_hashes", "hashes": out})


def wkv_hashes(torch, K, ref):
    """K14 in float32 at this checkout's ``tensorcore`` shapes, the
    model's chunk."""
    here, out = this_chip_smoke(), {}
    for b, s in [(1, s) for s in here.TC_WKV_S] + [here.TRAIN_SHAPES[
            here.RWKV]]:
        gen = torch.Generator(device="cuda").manual_seed(b * 100_003 + s)
        randn = here._randn(torch, gen, torch.float32, "cuda")
        y, state = here._wkv_case(torch, K, ref, randn, 4, b, s,
                                  None)["kernel"]()
        out[f"B={b},S={s}"] = [_sha(torch, y), _sha(torch, state)]
    emit({"phase": "wkv_hashes", "hashes": out})


def wkv_probe(torch, K, ref, timer):
    """K14's bf16 kernels at this checkout's ``tensorcore`` shapes."""
    from repro_torch.models import layers as L
    here = this_chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(26)
    randn = here._randn(torch, gen, torch.bfloat16, "cuda")
    for b, s in [(1, s) for s in here.TC_WKV_S] + [here.TRAIN_SHAPES[
            here.RWKV]]:
        case = here._wkv_case(torch, K, ref, randn, 2, b, s, None)
        fn = case["kernel"]
        emit({"phase": "wkv_probe", "B": b, "S": s, "ms": timer(fn),
              "kernel_ms": _kernel_ms(torch, timer, fn),
              "chunked_ms": timer(lambda: L.wkv6_chunked(*case["args"]))})


def convert_probe(torch, K, timer):
    """K15's device time per compiled edge, bf16."""
    from repro_torch.configs import get_config
    from repro_torch.core import compile_model
    here = this_chip_smoke()
    for model, tokens in [(m, here.COMPILE_TOKENS)
                          for m in here.COMPILE_MODELS] + [here.COMPILE_LONG]:
        c = compile_model(get_config(model), tokens=tokens)
        for i, case in enumerate(here._stream_cases(c, model, tokens)):
            data = here._edge_data(torch, case, torch.bfloat16, i, "cuda")
            ms = _kernel_ms(torch, timer, lambda: K.convert_layout(
                data, case["src"], case["dst"]), iters=5)
            dst = case["dst"]
            nbytes = (data.numel() + dst.num_tokens * dst.elem_shape[0]
                      * dst.elem_shape[1]) * 2
            emit({"phase": "convert_probe", "model": model, "tokens": tokens,
                  "edge": case["edge"], "bytes": nbytes,
                  "device_ms": sum(ms.values()),
                  "bound_ms": here.bound(nbytes, 0.0, "bfloat16")[0]})
            del data
            here._free(torch, "cuda")


def rwkv_burst(torch, cs):
    """rwkv6-7b's whole-prompt mixed burst at full size on the tree, then
    its profile (this checkout's ``profile_burst``, on the tree's
    engine)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(cs.RWKV), use_fused_kernels=True)
    params = cs._weights(torch, cfg, 2, jitter=True)
    cs.serve(torch, cfg, params, set(cs.rwkv_launches(1, 1)), init_s=0.0,
             chunked=None, phase="rwkv_burst")
    cs._free(torch, "cuda")
    prof = this_chip_smoke().profile_burst(torch, cfg, params, chunked=None)
    emit({"phase": "rwkv_burst_profile", "model": cs.RWKV,
          "layers": cfg.num_layers, **(prof or {"device_ms": None})})


def burst(torch, cs, model="llama3-8b", quant=None, phase="burst"):
    """The serving depth's (``SERVE_LAYERS``; zamba2 all 54 layers) mixed
    burst on the tree: chunked admission (zamba2 whole-prompt), under
    ``quant`` where given; then its profile."""
    from repro_torch.configs import get_config
    base = get_config(model)
    cfg = dataclasses.replace(
        base, num_layers=cs.SERVE_LAYERS.get(model, base.num_layers),
        use_fused_kernels=True)
    params = cs._weights(torch, cfg, 2, jitter=False)
    if model == cs.ZAMBA:
        chunked, expect = None, set(cs.zamba_launches(1, 1, quant or "none"))
    elif quant:
        chunked, expect = True, cs.QUANT_PATHS[(model, "chunked")]
    else:
        chunked, expect = True, cs.SERVE_PATHS[model]["chunked"]
    if quant:
        cfg = dataclasses.replace(cfg, quant=quant)
    cs.serve(torch, cfg, params, expect, init_s=0.0, chunked=chunked,
             phase=phase)
    cs._free(torch, "cuda")
    # The profile as this checkout's chip_smoke.serve takes it, through the
    # tree's engine.
    prof = this_chip_smoke().profile_burst(torch, cfg, params,
                                           chunked=chunked)
    emit({"phase": f"{phase}_profile", "model": model, "quant": quant,
          "layers": cfg.num_layers, **(prof or {"device_ms": None})})


def train(torch, cs, model="llama3-8b", layers=2):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(model), use_fused_kernels=True,
                              num_layers=layers or get_config(model).num_layers)
    cs.train(torch, cfg, model, steps=3, ckpt_every=None, replay_from=0,
             lr=3e-5, note=f"full width, {cfg.num_layers} layers")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=HERE,
                    help="checkout whose repro_torch and chip_smoke run")
    ap.add_argument("--ptxas", default=None,
                    help="file for nvcc's -Xptxas -v report of the build")
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "chip_phases"),
                    help="directory for the files a phase writes")
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "src")]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"phase": "device", "tree": tree, "nvidia_smi": smi})
    names = sorted({s for p in args.phases
                    for s in SOURCES.get(p, _build.KERNEL_SOURCES)}
                   & set(_build.KERNEL_SOURCES))
    t0 = time.perf_counter()
    try:
        _build.build_all(names)
    finally:
        spills = [f"{n}: {line.strip()}"
                  for n, log in _build.BUILD_LOG.items()
                  for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "built": list(_build.BUILD_LOG),
              "seconds_by_source": dict(_build.BUILD_SECONDS),
              "spills": spills})
        if args.ptxas:
            os.makedirs(os.path.dirname(os.path.abspath(args.ptxas)),
                        exist_ok=True)
            with open(args.ptxas, "w") as fh:
                for n, log in sorted(_build.BUILD_LOG.items()):
                    fh.write(f"== {n}\n{log}\n")
    if hasattr(cs, "record_plan_builds"):
        cs.record_plan_builds()
    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(2020)
    randn = cs._randn(torch, gen, torch.bfloat16, "cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for phase in args.phases:
        t1 = time.perf_counter()
        if phase == "k5_hashes":
            k5_hashes(torch, K, cs)
        elif phase == "norm":
            cs._norm_tc_rows(torch, timer, K, ref, randn, sms)
        elif phase == "xent":
            cs._xent_tc_rows(torch, timer, K, ref, randn, gen, sms)
        elif phase == "tensorcore":
            cs.check_tensorcore(torch, timer)
        elif phase == "kernel":
            cs.check_kernels(torch, timer)
        elif phase == "row_invariance":
            cs.check_row_invariance(torch)
        elif phase == "ffn_hashes":
            ffn_hashes(torch, K, ref)
        elif phase == "moe":
            moe(torch, K)
        elif phase == "moe_probe":
            moe_probe(torch, timer)
        elif phase == "burst":
            burst(torch, cs)
        elif phase == "granite_burst":
            burst(torch, cs, cs.GRANITE, phase="granite_burst")
        elif phase == "zamba_burst":
            burst(torch, cs, cs.ZAMBA, phase="zamba_burst")
        elif phase == "quant_burst":
            burst(torch, cs, quant=cs.QUANT_MODE, phase="quant_burst")
        elif phase == "flash_q_hashes":
            flash_q_hashes(torch, K)
        elif phase == "ssd_hashes":
            ssd_hashes(torch, K, ref)
        elif phase == "flash_q":
            this_chip_smoke()._flash_q_tc_rows(torch, timer, K, ref, randn)
        elif phase == "ssd":
            this_chip_smoke()._ssd_tc_rows(torch, timer, K, ref, randn)
        elif phase == "wkv_hashes":
            wkv_hashes(torch, K, ref)
        elif phase == "wkv":
            this_chip_smoke()._wkv_tc_rows(torch, timer, K, ref, randn)
        elif phase == "rwkv_burst":
            rwkv_burst(torch, cs)
        elif phase == "convert":
            cs.compile_path(torch, timer)
        elif phase == "wkv_probe":
            wkv_probe(torch, K, ref, timer)
        elif phase == "convert_probe":
            convert_probe(torch, K, timer)
        elif phase == "train":
            train(torch, cs)
        elif phase == "granite_train":
            train(torch, cs, cs.GRANITE_TRAIN, layers=None)
        elif phase == "qwen_kernel_cases":
            cs.check_kernels(torch, timer, (cs.qwen_kernel_cases,),
                             phase="qwen_kernel_cases")
            cs.check_qwen_rows(torch)
        elif phase == "qwen_fused_vs_eager":
            for m in cs.QWEN:
                cs.qwen_fused_vs_eager(torch, m)
        elif phase == "qwen_serve":
            for m in cs.QWEN:
                cs.qwen_serve(torch, m)
        elif phase == "qwen_train":
            for m in (cs.QWEN3, cs.QWEN2VL):
                train(torch, cs, m, layers=None)
        elif phase == "gemma_kernel_cases":
            cs.check_kernels(torch, timer, (cs.gemma_kernel_cases,),
                             phase="gemma_kernel_cases")
            cs.check_gemma_rows(torch, timer)
        elif phase == "gemma_fused_vs_eager":
            cs.gemma_fused_vs_eager(torch)
        elif phase == "gemma_serve":
            cs.gemma_serve(torch)
        elif phase == "gemma_quant_fused_vs_eager":
            cs.gemma_quant_fused_vs_eager(torch)
        elif phase == "gemma_quant_serve":
            cs.gemma_quant_serve(torch)
        elif phase == "flash_hashes":
            flash_hashes(torch, K)
        elif phase == "flash_times":
            flash_times(torch, K, ref, timer)
        elif phase == "hubert_kernel_cases":
            cs.check_kernels(torch, timer, (cs.hubert_kernel_cases,),
                             phase="hubert_kernel_cases")
        elif phase == "hubert_fused_vs_eager":
            cs.hubert_fused_vs_eager(torch)
        elif phase == "hubert_encode":
            cs.hubert_encode(torch)
        elif phase == "train_kernel_cases":
            cs.check_kernels(torch, timer, (cs.train_cases,),
                             phase="train_kernel_cases")
        elif phase == "gemma_train_fused_vs_eager":
            from repro_torch.configs import get_config
            cs.train_fused_vs_eager(
                torch, dataclasses.replace(
                    get_config(cs.GEMMA), num_layers=cs.GEMMA_TRAIN_LAYERS,
                    dtype="float32"), cs.GEMMA, jitter=True)
        elif phase == "train_w8_ste":
            cs.train_w8_ste_phase(torch)
        elif phase == "gemma_train":
            cs.gemma_train(torch)
        elif phase == "quant_train":
            cs.quant_train(torch)
        elif phase == "paged_hashes":
            paged_hashes(torch, K)
        elif phase == "serve_contiguous":
            cs.serve_contiguous(torch)
        elif phase == "serve_surface":
            cs.serve_surface(torch, timer)
        elif phase == "serve_launcher":
            cs.serve_launcher(torch)
        elif phase == "serve_pages":
            cs.serve_pages(torch, timer)
        elif phase == "plan_verify":
            os.makedirs(args.out, exist_ok=True)
            cs.plan_smem(torch, args.out)
            cs.plan_verify(torch, args.out)
        elif phase == "serve_telemetry":
            os.makedirs(args.out, exist_ok=True)
            cs.serve_telemetry(torch, args.out)
        elif phase == "obs_demo":
            os.makedirs(args.out, exist_ok=True)
            cs.obs_demo(torch, args.out)
        elif phase == "tune_roundtrip":
            cs.tune_roundtrip(torch)
        elif phase == "tune_serve":
            cs.tune_serve(torch, timer)
        elif phase == "hubert_train":
            cs.hubert_train(torch)
        elif phase == "dryrun":
            os.makedirs(args.out, exist_ok=True)
            cs.dryrun_phase(torch, args.out)
        elif phase == "examples":
            os.makedirs(args.out, exist_ok=True)
            cs.examples_phase(torch, args.out)
        else:
            raise SystemExit(f"chip_phases: unknown phase {phase}")
        emit({"phase": f"{phase}_done", "seconds": time.perf_counter() - t1})
    return 0


if __name__ == "__main__":
    sys.exit(main())
