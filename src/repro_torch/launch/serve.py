"""Serving launcher: batched greedy generation with the serving engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        [--smoke] [--layers N] [--fused] [--requests 8] [--prompt-len 32] \
        [--new-tokens 16] [--slots 4] [--seed 0] [--contiguous] \
        [--page-size N] [--device cpu]

Serves on the card unless ``--device`` names another (``cpu`` runs the
kernels' plain versions).  ``--fused`` selects the kernel plan (the
config's ``use_fused_kernels``; the registry's configs run the eager plan,
as the reference's launcher does), ``--smoke`` the reduced config and
``--layers`` cuts the depth.  ``--contiguous`` serves from the
``slots x max_len`` slot cache instead of the paged default;
``--page-size`` overrides the KV page size (default: the plan's KV stream
granule, 16 on the eager plan).  Weights are random, drawn from
``--seed``; the prompts too.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..kernels.common import resolve_device
from ..models import init_params
from ..serving.engine import ServingEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers (0: the config's)")
    ap.add_argument("--fused", action="store_true",
                    help="the kernel plan (default: the config's plan)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--contiguous", action="store_true",
                    help="contiguous slots*max_len KV cache instead of "
                         "the paged default")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page size (default: StreamPlan tile / 16)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.fused:
        cfg = dataclasses.replace(cfg, use_fused_kernels=True)
    if cfg.encoder_only:
        ap.error(f"{args.arch} is encoder-only: no decode step")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    engine = ServingEngine(cfg, params, batch_slots=args.slots,
                           max_len=args.prompt_len + args.new_tokens + 8,
                           paged=not args.contiguous,
                           page_size=args.page_size, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(1, cfg.vocab_size, args.prompt_len,
                            dtype=np.int32)
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    reqs = engine.generate(prompts, max_new_tokens=args.new_tokens)
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    ttft = np.mean([r.ttft_s for r in reqs])
    m = engine.metrics
    print(f"[serve] {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s), mean TTFT {ttft*1e3:.1f}ms")
    print(f"[serve] kv cache: {'paged' if m['paged'] else 'contiguous'}, "
          f"peak {m['kv_bytes_peak']} / reserved {m['kv_bytes_reserved']} "
          f"bytes, block efficiency {m['ticks']}/{m['scan_ticks']} ticks")
    for r in reqs[:2]:
        print(f"  req {r.rid}: {r.out_tokens[:8]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
