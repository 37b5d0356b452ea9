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
  burst      llama3-8b at full width, 16 layers, bf16: the chunked mixed
             burst (``chip_smoke.serve``), then the same burst through a
             fresh engine under ``torch.profiler`` (this checkout's
             ``chip_smoke.profile_burst``, on the tree's engine): device ms
             by stage, busy, wall and idle share;
  granite_burst
             granite-moe-3b at full width, 16 layers, bf16: as ``burst``;
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
             llama3-8b at full width, 16 layers, bf16, ``w8_kv8``: the
             chunked mixed burst, as ``burst``.

The card's name and power limit (nvidia-smi) come first.  The phases of
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
SOURCES = {"k5_hashes": ["block_matmul"], "ffn_hashes": ["streamed_ffn"],
           "norm": ["rmsnorm_matmul"],
           "xent": ["streamed_xent"],
           "burst": ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                     "flash_attention", "paged_attention", "block_matmul"],
           "train": ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                     "flash_attention", "block_matmul", "streamed_xent"],
           "moe": ["moe_experts"], "moe_probe": ["moe_experts"],
           "granite_burst": ["rmsnorm_matmul", "flash_mma", "flash_attention",
                             "paged_attention", "block_matmul", "row_norm",
                             "moe_experts"],
           "granite_train": ["rmsnorm_matmul", "flash_mma", "flash_attention",
                             "block_matmul", "streamed_xent", "row_norm",
                             "moe_experts"],
           "flash_q_hashes": ["flash_attention"],
           "flash_q": ["flash_mma", "flash_attention"],
           "ssd_hashes": ["mamba2_scan"], "ssd": ["mamba2_scan"],
           "zamba_burst": ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                           "flash_attention", "paged_attention",
                           "block_matmul", "row_norm", "mamba2_scan"],
           "quant_burst": ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                           "flash_attention", "paged_attention",
                           "block_matmul"]}


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
                    for s in SOURCES.get(p, _build.KERNEL_SOURCES)})
    t0 = time.perf_counter()
    try:
        _build.build_all(names)
    finally:
        spills = [f"{n}: {line.strip()}"
                  for n, log in _build.BUILD_LOG.items()
                  for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "built": list(_build.BUILD_LOG), "spills": spills})
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
        elif phase == "train":
            train(torch, cs)
        elif phase == "granite_train":
            train(torch, cs, cs.GRANITE_TRAIN, layers=None)
        else:
            raise SystemExit(f"chip_phases: unknown phase {phase}")
        emit({"phase": f"{phase}_done", "seconds": time.perf_counter() - t1})
    return 0


if __name__ == "__main__":
    sys.exit(main())
