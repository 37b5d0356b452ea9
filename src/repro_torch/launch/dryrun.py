"""Dry-run: every (arch x shape) cell on one card, without running a step.

For each cell ``run_cell`` builds the cell's kernel plan for the H100
(``core.stream_plan.plan_for``) and verifies it strictly for the run's
device (on the card the kernel lint also reports the cases the CUDA
builds refuse), sizes its memory, counts one step op by op
(``launch.op_analysis``: FLOPs, bytes, the peak of live intermediates)
and derives the roofline terms on the card's peaks (``launch.roofline``).
Nothing is allocated and no kernel launched: the count runs on meta
tensors.  The record keeps the reference's keys (``repro/launch/
dryrun.py``) with ``mesh`` "1" and ``chips`` 1; ``lower_s`` times the
plan build, ``compile_s`` its verification, ``analyze_s`` the count, and
``cost_xla_raw`` is null (no XLA module).  ``memory`` holds the exact
argument bytes (the float32 parameters; for training the two float32
AdamW moments and the step; the batch; for decode the contiguous
cache), ``temp_bytes`` (the counted peak of live intermediates),
``peak_bytes`` (their sum) and, on the card, ``total_bytes`` and
``fits`` (null on the CPU).

The plan verified is the kernel plan; the plan counted is the eager one
(a kernel wrapper does not run on meta tensors), and the record says so
(``counted_plan``).  Only the FLOPs do not depend on what runs the
step.  ``bytes_accessed`` and ``temp_bytes`` are the eager plan's, op by
op: every elementwise op's operands and results, far more traffic than
the kernel plan's stage boundaries move.  So ``memory_s``, ``bound``,
``step_s_lower_bound`` and ``mfu_upper_bound`` describe the eager plan
and are no bound on the kernel plan's step; a share of the card's peak
is taken from ``compute_s`` alone.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k [--perf] [--out results.json] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out dir/]

Runs on the card unless ``--device cpu`` (no card: it raises).  The
meshes of the reference (``--multi-pod``, ``--both-meshes``) and the
``embed``/``sp`` pin modes of ``--perf`` come with the distributed slice
(ROADMAP queue 1 item 10) and raise ``NotImplementedError``.  With
``--all`` a failed cell is recorded as ``<tag>__FAILED``, the run goes on,
and the exit code is 1 if any cell failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

from ..configs import (ALL_SHAPES, ARCHS, cells, get_config, get_shape,
                       skipped_cells)
from ..kernels.common import DeviceLike, resolve_device
from .roofline import roofline_from_counts


def _no_meshes(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the multi-device meshes need the distributed slice, not "
        "ported yet (ROADMAP queue 1 item 10)")


def cell_plan(cfg, shape, perf=False):
    """The cell's kernel-plan config and its plan for the H100: B x S
    tokens, or B tokens over an S-position cache for decode."""
    from ..core.stream_plan import plan_for
    from ..distributed.steps import perf_config

    pcfg = dataclasses.replace(perf_config(cfg, perf),
                               use_fused_kernels=True)
    if shape.kind == "decode":
        return pcfg, plan_for(pcfg, shape.global_batch, shape.seq_len)
    return pcfg, plan_for(pcfg, shape.global_batch * shape.seq_len)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             perf: object = False, device: DeviceLike = None,
             verbose: bool = True) -> dict:
    """Plan, verify, size and count one cell; return the dry-run record."""
    import torch

    from ..analysis import PlanVerificationError, verify_plan
    from ..analysis.diagnostics import clean, errors
    from .op_analysis import COLLECTIVES, count_cell

    if multi_pod:
        raise _no_meshes("the multi-pod mesh")
    dev = resolve_device(device)
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": "1", "chips": 1,
           "kind": shape.kind, "perf": perf, "device": dev.type}
    t0 = time.perf_counter()
    pcfg, plan = cell_plan(cfg, shape, perf)
    rec["lower_s"] = round(time.perf_counter() - t0, 3)
    t0 = time.perf_counter()
    diags = verify_plan(plan, pcfg, device=dev.type)
    rec["compile_s"] = round(time.perf_counter() - t0, 3)
    if errors(diags):
        raise PlanVerificationError(diags)
    rec["plan"] = {"tokens": plan.tokens, "kv_len": plan.kv_len,
                   "clean": clean(diags),
                   "diagnostics": [str(d) for d in diags
                                   if d.severity != "info"]}

    t0 = time.perf_counter()
    count, memory = count_cell(cfg, shape, perf=perf)
    rec["analyze_s"] = round(time.perf_counter() - t0, 2)
    mem = {"argument_bytes": memory["argument_bytes"],
           "output_bytes": memory["output_bytes"],
           "temp_bytes": count.temp_bytes,
           "alias_bytes": memory["alias_bytes"]}
    # The counted peak already holds the outputs the step creates.
    mem["peak_bytes"] = mem["argument_bytes"] + mem["temp_bytes"]
    if dev.type == "cuda":
        mem["total_bytes"] = torch.cuda.get_device_properties(
            dev).total_memory
        mem["fits"] = mem["peak_bytes"] <= mem["total_bytes"]
    else:
        mem["total_bytes"], mem["fits"] = None, None
    rec["memory"] = mem
    if "unpriced_ops" in memory:
        rec["unpriced_ops"] = memory["unpriced_ops"]
    rec["counted_plan"] = "eager"
    rec["cost_xla_raw"] = None
    rec["cost"] = {"flops": float(count.flops),
                   "bytes_accessed": float(count.bytes)}
    rec["collectives"] = {**{k: 0.0 for k in COLLECTIVES}, "total": 0.0,
                          "operand_total": 0.0, "counts": 0}
    rec["roofline"] = roofline_from_counts(cfg, shape, rec, chips=1)
    if verbose:
        r = rec["roofline"]
        print(f"[dryrun] {arch} x {shape_name} mesh=1 "
              f"plan={'clean' if rec['plan']['clean'] else 'warn'} "
              f"count={rec['analyze_s']}s  "
              f"args={mem['argument_bytes']/2**30:.2f}GiB "
              f"temp={mem['temp_bytes']/2**30:.2f}GiB fits={mem['fits']}  "
              f"flops={count.flops:.4e} eager_bytes={count.bytes:.4e}  "
              f"compute={r['compute_s']*1e3:.2f}ms "
              f"memory={r['memory_s']*1e3:.2f}ms "
              f"collective={r['collective_s']*1e3:.2f}ms "
              f"bound={r['bound']}", flush=True)
    return rec


def _tag(arch: str, shape_name: str, perf) -> str:
    return f"{arch}__{shape_name}__pod1" + (f"__perf_{perf}" if perf
                                             else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(ALL_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (not ported: raises)")
    ap.add_argument("--perf", nargs="?", const="all", default=False,
                    choices=["all", "embed", "sp"],
                    help="apply the §Perf optimization set (pin mode: "
                         "all; embed|sp need a mesh and raise)")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--both-meshes", action="store_true",
                    help="with --all: single-pod and multi-pod (not "
                         "ported: raises)")
    ap.add_argument("--out", default=None, help="JSON output path or dir")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the plans are verified and fits is "
                         "judged (default: the card; 'cpu' for the plain "
                         "path)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise _no_meshes("--multi-pod")
    if args.both_meshes:
        raise _no_meshes("--both-meshes")
    if args.perf in ("embed", "sp"):
        raise _no_meshes(f"--perf {args.perf}")
    device = resolve_device(args.device)

    results, failures = [], []

    def save(rec, tag):
        if args.out:
            outdir = Path(args.out)
            outdir.mkdir(parents=True, exist_ok=True)
            (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))

    if args.all:
        for cfg, shape in cells():
            tag = _tag(cfg.name, shape.name, args.perf)
            if args.skip_existing and args.out and \
                    (Path(args.out) / f"{tag}.json").exists():
                print(f"[dryrun] skip existing {tag}", flush=True)
                continue
            try:
                rec = run_cell(cfg.name, shape.name, perf=args.perf,
                               device=device)
                results.append(rec)
                save(rec, tag)
            except Exception as e:   # record and continue
                traceback.print_exc()
                failures.append({"arch": cfg.name, "shape": shape.name,
                                 "error": repr(e)})
                save({"arch": cfg.name, "shape": shape.name,
                      "error": repr(e)}, tag + "__FAILED")
        for arch, shape, reason in skipped_cells():
            print(f"[dryrun] SKIP {arch} x {shape}: {reason}", flush=True)
        print(f"[dryrun] done: {len(results)} ok, {len(failures)} failed",
              flush=True)
        return 1 if failures else 0

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    rec = run_cell(args.arch, args.shape, perf=args.perf, device=device)
    if args.out:
        save(rec, _tag(args.arch, args.shape, args.perf))
    else:
        print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
