"""Autotune round-trip check: ``python -m repro_torch.tuning --arch gpt2
[--device cpu|cuda]``.

The executable form of DESIGN.md §16's build-once/reuse contract, as the
reference's ``python -m repro.tuning``:

  1. The first engine start with ``autotune=<table path>`` tunes (only
     lint-legal candidates are scored) and persists the table to disk.
  2. A second engine start against the same path makes ZERO measurements
     (every candidate served from the table) and resolves an equal
     StreamPlan.
  3. Both engines greedy-decode equal tokens for equal prompts.

``--device cpu`` runs the reduced config, whose candidates the analytic
surrogate scores; without it the card runs the config at full width and
depth (gpt2: 24 layers at width 1024), its candidates timed with CUDA
events, and the table's backend is the card's fingerprint.  The weights
are random from seed 0, jittered (zero norm scales would zero every gpt2
logit, and equal tokens would prove nothing).  Exits nonzero on any
violation; prints a stats JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Tuple


def round_trip(cfg, params, prompts, *, path: str, device, slots: int = 2,
               max_len: int = 64, new_tokens: int = 8
               ) -> Tuple[Dict[str, object], List[str]]:
    """Two engine starts over one table file: ``(stats, failures)``.
    ``stats`` holds the counts, both plans' page size and chunk, the first
    start's tuning seconds and the tokens; ``failures`` names every broken
    clause of the contract."""
    from ..core.stream_plan import plan_for
    from ..serving.engine import ServingEngine

    failures: List[str] = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    def start():
        t0 = time.perf_counter()
        eng = ServingEngine(cfg, params, batch_slots=slots, max_len=max_len,
                            autotune=path, device=device)
        init_s = time.perf_counter() - t0
        out = eng.generate([p.copy() for p in prompts],
                           max_new_tokens=new_tokens)
        return eng, init_s, [r.out_tokens for r in out]

    # A fresh process stand-in: the plan cache holds no tuned plan, so
    # each engine resolves everything through its own (disk) table.
    plan_for.cache_clear()
    eng1, init1, out1 = start()
    check(os.path.exists(path), "first start persisted the table")
    check(eng1.tuner.stats.measured > 0,
          "first start scored candidates not in the table")
    check(eng1.metrics["tune_entries"] > 0,
          "first start filled table entries")
    check(eng1.tuner.stats.candidates
          >= eng1.tuner.stats.pruned + eng1.tuner.stats.measured,
          "candidate accounting (considered >= pruned + scored)")
    measured_before = eng1.tuner.stats.measured
    plan_for.cache_clear()
    eng2, init2, out2 = start()
    check(eng2.tuner.stats.measured == 0,
          "second start performed zero measurements "
          f"(got {eng2.tuner.stats.measured})")
    check(eng2.metrics["tune_hits"] > 0,
          "second start served candidates from the table")
    check(eng1.plan == eng2.plan, "second start resolved an equal plan")
    check(eng1.tuner.stats.measured == measured_before,
          "second start did not dirty the first tuner")
    for i, (a, b) in enumerate(zip(out1, out2)):
        check(a == b, f"greedy tokens equal for request {i}")
    stats = {
        "arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
        "device": str(eng1.device), "table": path,
        "backend": eng2.tuner.table.backend,
        "entries": eng2.metrics["tune_entries"],
        "sources": sorted({e.source
                           for e in eng2.tuner.table.entries.values()}),
        "candidates": eng1.tuner.stats.candidates,
        "pruned_by_lint": eng1.tuner.stats.pruned,
        "measured_first_start": measured_before,
        "measured_second_start": eng2.tuner.stats.measured,
        "table_hits_second_start": eng2.tuner.table.hits,
        "plan_source": eng2.metrics["plan_source"],
        "stages_tuned": eng1.tuner.stats.stages,
        "page_size": eng1.metrics["page_size"],
        "prefill_chunk": eng1.metrics["prefill_chunk"],
        "init_s": [init1, init2], "tokens": out1,
        "ok": not failures,
    }
    return stats, failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.tuning")
    ap.add_argument("--arch", default="gpt2")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="cpu: the reduced config, scored by the analytic "
                         "surrogate; default the card: full size, timed")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=None,
                    help="default 64 on the CPU, 1024 on the card")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--table", default=None,
                    help="table path (default: a fresh temp dir)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_config
    from ..kernels.common import resolve_device
    from ..models import init_params
    from ..serving.accuracy import jitter_params

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if device.type == "cpu":
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, use_fused_kernels=True)
    max_len = args.max_len or (64 if device.type == "cpu" else 1024)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    params = jitter_params(params,
                           torch.Generator(device=device).manual_seed(1))
    prompts = [np.arange(1, 9, dtype=np.int32),
               np.arange(3, 17, dtype=np.int32)]

    tmp = None
    if args.table is None:
        tmp = tempfile.TemporaryDirectory(prefix="repro_torch_tune_")
        path = os.path.join(tmp.name, f"{cfg.name}.json")
    else:
        path = args.table
    try:
        stats, failures = round_trip(
            cfg, params, prompts, path=path, device=device,
            slots=args.slots, max_len=max_len, new_tokens=args.new_tokens)
    finally:
        if tmp is not None:
            tmp.cleanup()
    for what in failures:
        print(f"FAIL  {what}", file=sys.stderr)
    print(json.dumps(stats, indent=2))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
