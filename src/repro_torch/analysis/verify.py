"""Stream verifier: orchestrate the four static passes over a plan.

Library entry point::

    from repro_torch.analysis import verify_plan
    diags = verify_plan(plan, cfg, slots=8, max_len=256, device="cuda")

and a CLI sweeping the configs registry::

    PYTHONPATH=src python -m repro_torch.analysis.verify \\
        --config all --quant all --device cpu

A copy of the reference's ``repro.analysis.verify`` for the port's plans
and Hopper kernels.  Nothing here launches a kernel or allocates a device
tensor: plans come from the DSE pipeline, the pool schema is the
``CacheDef`` tree, not the pools.  ``device`` says where the plan runs:
on ``"cuda"`` the kernel lint also reports the cases a CUDA build refuses
(``unsupported-case``); on ``"cpu"`` the plain versions run every case.
Exit status is non-zero when any config produces an error or warning
diagnostic: shipped plans must verify clean (info-level notes are fine).
``--tuned`` autotunes every plan first (an in-memory table, the tuner on
``--device``: CUDA-event timings on the card, the analytic surrogate on
the CPU).  The port builds no mesh yet: ``--mesh`` other than 1 is
refused (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional, Tuple

from ..configs.base import ModelConfig
from ..core.platforms import H100, PLATFORMS, Platform
from ..core.stream_plan import StreamPlan
from .diagnostics import Diagnostic, PlanVerificationError, clean, errors
from .effects import check_effects
from .itensor_check import check_itensors
from .kernel_lint import check_kernels
from .sharding_check import check_sharding

_SEV_ORDER = {"error": 0, "warning": 1, "info": 2}
DEVICES = ("cuda", "cpu")


def _platform_for(plan: StreamPlan) -> Platform:
    """Resolve the Platform a plan recorded (by display name)."""
    for p in PLATFORMS.values():
        if p.name == plan.platform:
            return p
    key = str(plan.platform).lower().replace("-", "_")
    return PLATFORMS.get(key, H100)


def _mesh_axes_of(mesh) -> Dict[str, int]:
    return {str(a): int(mesh.shape[a]) for a in mesh.axis_names}


def _resolve_mesh(plan: StreamPlan, mesh
                  ) -> Tuple[Dict[str, int], List[Diagnostic]]:
    """Mesh axes to verify against: the plan's own record, cross-checked
    against an explicitly supplied mesh (any object with ``axis_names``
    and a ``shape`` mapping) when both exist."""
    planned = dict(plan.mesh_axes)
    if mesh is None:
        return planned, []
    given = _mesh_axes_of(mesh)
    if planned and planned != given:
        return planned, [Diagnostic(
            "error", "sharding", "plan", "mesh-mismatch",
            f"plan was built for mesh {planned} but is verified against "
            f"{given} — claims would target the wrong axis sizes",
            "rebuild the plan for the mesh it will run under")]
    return given, []


def verify_plan(plan: StreamPlan, cfg: ModelConfig, mesh=None, *,
                slots: Optional[int] = None,
                max_len: Optional[int] = None,
                page_size: Optional[int] = None,
                device: str = "cuda",
                signatures: Optional[Dict[str, Dict[str, Any]]] = None,
                cache_defs=None) -> List[Diagnostic]:
    """Run all four static passes; returns diagnostics, severest first.

    Pure: no kernel is launched, no tensor allocated.  Pool checks need
    ``slots``/``max_len`` (or an explicit ``cache_defs``) and are skipped
    otherwise; ``device`` ("cuda" or "cpu") is where the plan runs.
    """
    if device not in DEVICES:
        raise ValueError(f"unknown device {device!r} (have {DEVICES})")
    platform = _platform_for(plan)
    mesh_axes, diags = _resolve_mesh(plan, mesh)
    diags += check_itensors(plan, cfg, platform.fusion_budget(0.5))
    diags += check_kernels(plan, cfg, platform, device=device)
    if mesh_axes:
        diags += check_sharding(plan, cfg, mesh_axes)
    diags += check_effects(plan, cfg, slots=slots, max_len=max_len,
                           page_size=page_size, signatures=signatures,
                           cache_defs=cache_defs)
    diags.sort(key=lambda d: _SEV_ORDER[d.severity])
    return diags


def verify_or_raise(plan: StreamPlan, cfg: ModelConfig, mesh=None,
                    **kw) -> List[Diagnostic]:
    """``verify_plan`` that raises ``PlanVerificationError`` on errors."""
    diags = verify_plan(plan, cfg, mesh, **kw)
    errs = errors(diags)
    if errs:
        raise PlanVerificationError(diags)
    return diags


# --------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------- #

_QUANT_ALL = ("none", "kv_int8", "w8_kv8")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.verify",
        description="Statically verify the H100 StreamPlans of the config "
                    "registry (no kernel launched, no device needed).")
    ap.add_argument("--config", default="all",
                    help="'all' or comma-separated arch names")
    ap.add_argument("--quant", default="all",
                    help="'all' (= %s) or comma-separated QuantModes"
                         % ",".join(_QUANT_ALL))
    ap.add_argument("--mesh", default="1",
                    help="device counts; the port verifies one device "
                         "(ROADMAP queue 1 item 10 brings meshes)")
    ap.add_argument("--tokens", type=int, default=4)
    ap.add_argument("--kv-len", type=int, default=64)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--full", action="store_true",
                    help="verify the full-size configs instead of the "
                         "reduced smoke variants")
    ap.add_argument("--tuned", action="store_true",
                    help="autotune every plan (in-memory hybrid table, "
                         "the tuner on --device) before verifying: checks "
                         "that tuned plans also pass the verifier")
    ap.add_argument("--device", choices=DEVICES, default=None,
                    help="where the plans run: 'cuda' also reports the "
                         "cases the CUDA builds refuse (default: cuda "
                         "with --full, cpu for the reduced configs, whose "
                         "head dims only the plain versions run)")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print info-level diagnostics")
    args = ap.parse_args(argv)
    if [m.strip() for m in args.mesh.split(",") if m.strip()] != ["1"]:
        ap.error("--mesh: the port builds no mesh yet (ROADMAP queue 1 "
                 "item 10); verify one device with --mesh 1")
    device = args.device or ("cuda" if args.full else "cpu")

    import dataclasses

    from ..configs import ARCHS
    from ..core.stream_plan import build_stream_plan

    names = (sorted(ARCHS) if args.config == "all"
             else [c.strip() for c in args.config.split(",") if c.strip()])
    quants = (_QUANT_ALL if args.quant == "all"
              else [q.strip() for q in args.quant.split(",") if q.strip()])

    unclean = 0
    for name in names:
        base = ARCHS[name] if args.full else ARCHS[name].reduced()
        for quant in quants:
            cfg = dataclasses.replace(base, quant=quant,
                                      use_fused_kernels=True)
            tuner = None
            if args.tuned:
                from ..tuning import Tuner
                tuner = Tuner(device=device)
            plan = build_stream_plan(cfg, tokens=args.tokens,
                                     kv_len=args.kv_len, tune=tuner)
            diags = verify_plan(plan, cfg, slots=args.slots,
                                max_len=args.kv_len, device=device)
            tag = f"{name:<22} quant={quant:<8} device={device}"
            if args.tuned:
                tag += " tuned"
            if clean(diags):
                print(f"OK    {tag}  ({len(diags)} info)")
                shown = diags if args.verbose else []
            else:
                unclean += 1
                n_err = len(errors(diags))
                print(f"FAIL  {tag}  ({n_err} errors, "
                      f"{len(diags) - n_err} warnings/info)")
                shown = [d for d in diags
                         if args.verbose or d.severity != "info"]
            for d in shown:
                print(f"      {d}")
    if unclean:
        print(f"{unclean} config/quant combinations did not verify clean",
              file=sys.stderr)
        return 1
    print("all plans verified clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
