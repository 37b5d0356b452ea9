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
  tensorcore, kernel, row_invariance
             those phases of ``chip_smoke.py`` whole;
  burst      llama3-8b at full width, 16 layers, bf16: the chunked mixed
             burst (``chip_smoke.serve``), then the same burst through a
             fresh engine under ``torch.profiler`` (this checkout's
             ``chip_smoke.profile_burst``, on the tree's engine): device ms
             by stage, busy, wall and idle share;
  train      llama3-8b at full width, 2 layers: ``chip_smoke.train``'s
             3 steps with a profiled step.

The card's name and power limit (nvidia-smi) come first.  The phases of
the tree's own ``chip_smoke.py`` are used, so a phase that an older tree
lacks (norm, xent) runs only on trees that have it.
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
SOURCES = {"k5_hashes": ["block_matmul"], "norm": ["rmsnorm_matmul"],
           "xent": ["streamed_xent"],
           "burst": ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                     "flash_attention", "paged_attention", "block_matmul"],
           "train": ["rmsnorm_matmul", "streamed_ffn", "flash_mma",
                     "flash_attention", "block_matmul", "streamed_xent"]}


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


def burst(torch, cs):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=16,
                              use_fused_kernels=True)
    params = cs._weights(torch, cfg, 2, jitter=False)
    cs.serve(torch, cfg, params, cs.SERVE_PATHS["llama3-8b"]["chunked"],
             init_s=0.0)
    cs._free(torch, "cuda")
    # The profile as this checkout's chip_smoke.serve takes it, through the
    # tree's engine.
    prof = this_chip_smoke().profile_burst(torch, cfg, params)
    emit({"phase": "burst_profile", "layers": cfg.num_layers,
          **(prof or {"device_ms": None})})


def train(torch, cs):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2,
                              use_fused_kernels=True)
    cs.train(torch, cfg, "llama3-8b", steps=3, ckpt_every=None,
             replay_from=0, lr=3e-5, note="full width cut to 2 layers")


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
        elif phase == "burst":
            burst(torch, cs)
        elif phase == "train":
            train(torch, cs)
        else:
            raise SystemExit(f"chip_phases: unknown phase {phase}")
        emit({"phase": f"{phase}_done", "seconds": time.perf_counter() - t1})
    return 0


if __name__ == "__main__":
    sys.exit(main())
