"""``python -m repro_torch.obs`` — telemetry demo / self-check CLI.

Port of ``python -m repro.obs``.  ``--demo`` bursts a gpt2 engine (chunked
prefill + speculative decode, the same mixed traffic the reference's demo
sends), with telemetry ON and OFF, then:

  * checks the greedy tokens are bit-identical (telemetry is a pure
    observer) and the OFF engine recorded zero events,
  * checks the trace-probe counters equal the matching TRACE_* event
    counts (the port builds no per-shape programs: both are 0),
  * validates the Chrome trace against the schema checker and the
    TTFT/TPOT percentile ordering (p50 <= p90 <= p99),
  * writes three artifacts to ``--out`` (default ``obs_demo/``):
    ``trace.json`` (load in https://ui.perfetto.dev or
    chrome://tracing), ``events.jsonl`` and ``metrics.prom``.

The engine runs on the card unless ``--device`` names another.  With
``--device cpu`` it is the reference demo's engine: gpt2's reduced config
in float32 on the kernel plan (the kernels' plain versions).  On the card
it is gpt2 at full width cut to ``--layers`` (default 2) in the config's
dtype: the reduced config's head dim 16 has no CUDA case (the Hopper
builds take head dims 64, 80, 128 and 320, and the wrappers refuse the
rest), as for ``repro_torch.launch.serve --layers``.  Either way the
weights are drawn from a seeded ``torch.Generator`` and jittered (gpt2's
zero-initialised LayerNorm scales would zero every logit).

``main`` returns nonzero on any failed check, so a caller can run it
in-process as a smoke test.  ``--tokens`` / ``--prompts`` scale the burst.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List

import numpy as np
import torch

from . import (
    TRACE_DECODE,
    TRACE_PREFILL,
    TRACE_VERIFY,
    chrome_trace,
    events_jsonl,
    prometheus_text,
    validate_chrome_trace,
)


def _demo_config(device: torch.device, layers: int):
    from ..configs import get_config

    cfg = get_config("gpt2")
    if device.type == "cpu":
        return dataclasses.replace(cfg.reduced(), dtype="float32",
                                   use_fused_kernels=True)
    return dataclasses.replace(cfg, num_layers=layers,
                               use_fused_kernels=True)


def _demo_engine(cfg, params, telemetry: bool, *, max_len: int, device):
    from ..serving import ServingEngine

    return ServingEngine(cfg, params, batch_slots=2, max_len=max_len,
                         decode_block=4, chunked=True,
                         prefill_chunk=max(8, max_len // 8),
                         speculative=True, draft_len=4,
                         telemetry=telemetry, device=device)


def _prompts(cfg, n: int, max_len: int) -> List[np.ndarray]:
    periods = ((1, 2, 3, 4), (7, 8, 9), (5, 6), (2, 9), (3, 1, 4))
    lens = (max_len // 3, max_len // 6, max_len // 2, max_len // 4,
            max_len // 5)
    v = cfg.vocab_size
    return [np.array((periods[i % len(periods)] * max_len)
                     [:max(2, lens[i % len(lens)])], np.int32) % v
            for i in range(n)]


def run_demo(out_dir: str, *, n_prompts: int, new_tokens: int,
             max_len: int, device=None, layers: int = 2) -> int:
    from ..kernels.common import resolve_device
    from ..models import init_params
    from ..serving.accuracy import jitter_params

    failures: List[str] = []

    def check(ok: bool, what: str) -> None:
        print(("  ok   " if ok else "  FAIL ") + what)
        if not ok:
            failures.append(what)

    dev = resolve_device(device)
    cfg = _demo_config(dev, layers)
    print(f"building engines (telemetry on / off): {cfg.name}, "
          f"{cfg.num_layers} layers, {cfg.dtype}, on {dev} ...")
    params = jitter_params(
        init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev),
        torch.Generator(device=dev).manual_seed(10))
    eng = _demo_engine(cfg, params, True, max_len=max_len, device=dev)
    eng_off = _demo_engine(cfg, params, False, max_len=max_len, device=dev)
    prompts = _prompts(cfg, n_prompts, max_len)

    t0 = time.perf_counter()
    reqs = eng.generate([p.copy() for p in prompts],
                        max_new_tokens=new_tokens)
    wall_on = time.perf_counter() - t0
    t0 = time.perf_counter()
    reqs_off = eng_off.generate([p.copy() for p in prompts],
                                max_new_tokens=new_tokens)
    wall_off = time.perf_counter() - t0
    print(f"burst: {n_prompts} prompts x {new_tokens} tokens, "
          f"{wall_on * 1e3:.0f}ms on / {wall_off * 1e3:.0f}ms off")

    check([r.out_tokens for r in reqs] == [r.out_tokens for r in reqs_off],
          "greedy tokens identical with telemetry on vs off")
    check(eng_off.obs.events == () and not eng_off.obs.enabled,
          "telemetry-off recorder captured zero events")
    check(len(eng.obs.events) > 0, "telemetry-on recorder captured events")
    for name, probe in ((TRACE_PREFILL, "prefill_traces"),
                        (TRACE_DECODE, "decode_traces"),
                        (TRACE_VERIFY, "verify_traces")):
        check(eng.obs.count(name) == eng.metrics[probe],
              f"{name} events == {probe} ({eng.metrics[probe]:g})")

    trace = chrome_trace(eng.obs.events)
    errs = validate_chrome_trace(trace)
    check(not errs, "chrome trace passes schema validation"
          + ("" if not errs else f": {errs[:3]}"))

    snap = eng.snapshot("last_generate")
    for h in ("ttft_s", "tpot_s"):
        p50, p90, p99 = (snap[f"{h}_p50"], snap[f"{h}_p90"],
                         snap[f"{h}_p99"])
        check(p50 <= p90 <= p99,
              f"{h} percentiles ordered: p50={p50:.4g} <= p90={p90:.4g}"
              f" <= p99={p99:.4g}")
        check(snap[f"{h}_count"] == len(reqs),
              f"{h} observed once per request")

    prom = prometheus_text(eng.registry)
    check("repro_ttft_s_bucket{" in prom and "repro_generated_total" in prom,
          "prometheus exposition has histograms and counters")

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "trace.json"), "w") as fh:
        json.dump(trace, fh)
    with open(os.path.join(out_dir, "events.jsonl"), "w") as fh:
        fh.write(events_jsonl(eng.obs.events))
    with open(os.path.join(out_dir, "metrics.prom"), "w") as fh:
        fh.write(prom)
    print(f"wrote {out_dir}/trace.json ({len(trace['traceEvents'])} rows, "
          f"load in ui.perfetto.dev), events.jsonl "
          f"({len(eng.obs.events)} events), metrics.prom")

    if failures:
        print(f"{len(failures)} check(s) FAILED", file=sys.stderr)
        return 1
    print("all checks passed")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--demo", action="store_true",
                    help="run the burst demo + self-checks")
    ap.add_argument("--out", default="obs_demo",
                    help="artifact directory (default: obs_demo/)")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--layers", type=int, default=2,
                    help="gpt2's depth on the card (full width)")
    args = ap.parse_args(argv)
    if not args.demo:
        ap.print_help()
        return 2
    return run_demo(args.out, n_prompts=args.prompts,
                    new_tokens=args.tokens, max_len=args.max_len,
                    device=args.device, layers=args.layers)


if __name__ == "__main__":
    raise SystemExit(main())
