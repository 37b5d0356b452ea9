"""Serving example of the port: batched requests through the
continuous-batching engine (per-request prefill into the paged KV cache
-> block decode across slots, requests joining as slots free), reporting
the paper's metrics (TTFT, decode tok/s) per request
(``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch zamba2-2.7b]
        [--device cpu]

Random weights drawn from seed 0 on the device; the reduced config runs
the eager plan, as the reference's registry configs do.  Runs on the card
unless ``--device cpu``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import ServingEngine


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=[a for a in sorted(ARCHS)
                             if not ARCHS[a].encoder_only])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    engine = ServingEngine(cfg, params, batch_slots=3,
                           max_len=args.prompt_len + args.new_tokens + 8,
                           device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, args.prompt_len,
                            dtype=np.int32) for _ in range(args.requests)]
    t0 = time.perf_counter()
    reqs = engine.generate(prompts, max_new_tokens=args.new_tokens)
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in reqs)
    print(f"{args.arch} ({cfg.name}): {len(reqs)} requests, "
          f"{total} tokens, {total/dt:.1f} tok/s aggregate")
    for r in reqs:
        print(f" req{r.rid}: ttft={r.ttft_s*1e3:6.1f}ms "
              f"latency={r.latency_s*1e3:7.1f}ms tokens={r.out_tokens[:6]}")
    assert all(len(r.out_tokens) == args.new_tokens for r in reqs)
    print("serve_lm OK")
    return reqs


if __name__ == "__main__":
    main()
