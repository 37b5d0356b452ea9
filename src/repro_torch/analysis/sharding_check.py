"""Pass 3 — sharding-claim checker.

Validates every ``KernelChoice.sharding`` claim the plan carries against
the mesh it was built for, statically reproducing the decisions
``distributed/sharding.spec_for`` and the wrappers' ``_claim_axis``
would make at trace time:

  * claimed axes must exist on the mesh;
  * feature-dim claims must divide (quantum-aware: head/expert counts,
    never mid-head) — an indivisible claim would mis-slice operands;
  * no two dims of one stage may claim the same axis;
  * psum coherence between paired stages: the column-parallel qkv
    projections ("out" claim) must reduce over the SAME axis the
    row-parallel consumers use (attention's kv_heads slicing, the FFN's
    gate/up -> down psum, MoE's expert psum) — mismatched axes would
    psum partial sums over the wrong groups;
  * replication fallbacks are reported (info): token/batch claims whose
    extents a >1 axis doesn't divide degrade to replication at trace
    time (grouped ('pod','data') claims degrade suffix-first), and
    feature dims left unclaimed on a >1 'model' axis replicate — the
    declared, reachable fallback, never eager.

A copy of the reference's ``repro.analysis.sharding_check``.  The port
builds no mesh yet (ROADMAP queue 1 item 10): it checks plans that carry
``mesh_axes`` and claims, as tests build them by hand.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..configs.base import ModelConfig
from ..core.stream_plan import KernelChoice, StreamPlan
from .diagnostics import Diagnostic


def _axes_of(claim) -> Tuple[str, ...]:
    return claim if isinstance(claim, tuple) else (claim,)


def _size(mesh_axes: Dict[str, int], axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= int(mesh_axes.get(a, 1))
    return max(1, n)


def _dim_extents(cfg: ModelConfig, plan: StreamPlan, kind: str
                 ) -> Dict[str, Tuple[int, int, str]]:
    """dim -> (extent, quantum, class) for every claimable grid dim.
    class: "token" dims degrade to replication at trace time (info);
    "feature" dims must divide (error)."""
    heads = cfg.ssm_heads if cfg.is_mamba else cfg.rwkv_heads
    return {
        "tokens": (plan.tokens, 1, "token"),
        "batch": (plan.tokens, 1, "token"),
        "out": (min(cfg.q_dim, cfg.kv_dim), cfg.head_dim_, "feature"),
        "kv_heads": (cfg.num_kv_heads, 1, "feature"),
        "d_ff": (cfg.d_ff, 1, "feature"),
        "experts": (cfg.num_experts, 1, "feature"),
        "heads": (heads, 1, "feature"),
    }


def _reduction_claim(stage: str, choice: KernelChoice):
    """The tensor-parallel axis a stage reduces/slices over, if any."""
    if stage == "qkv":
        return choice.claim("out")
    if stage in ("attention", "decode_attn", "verify_attn"):
        return choice.claim("kv_heads")
    if stage == "ffn":
        return choice.claim("d_ff") or choice.claim("experts")
    return None


def check_sharding(plan: StreamPlan, cfg: ModelConfig,
                   mesh_axes: Dict[str, int]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    model_size = int(mesh_axes.get("model", 1))

    for kind, stage, choice in plan.stage_choices():
        if not choice.fused:
            continue
        where = f"{kind}.{stage}"
        extents = _dim_extents(cfg, plan, kind)
        used: Dict[str, str] = {}

        for dim, claim in choice.sharding:
            axes = _axes_of(claim)
            missing = [a for a in axes if a not in mesh_axes]
            if missing:
                diags.append(Diagnostic(
                    "error", "sharding", where, "unknown-axis",
                    f"dim {dim!r} claims mesh axis {missing[0]!r} which "
                    f"the mesh {dict(mesh_axes)} does not have",
                    "claim only axes of the mesh the plan targets"))
                continue
            for a in axes:
                if a in used:
                    diags.append(Diagnostic(
                        "error", "sharding", where, "axis-collision",
                        f"dims {used[a]!r} and {dim!r} both claim mesh "
                        f"axis {a!r} — one shard_map spec cannot split "
                        "two grid dims over one axis",
                        "claim disjoint axes per stage"))
                used[a] = dim
            size = _size(mesh_axes, axes)
            if size <= 1:
                continue
            extent, quantum, klass = extents.get(dim, (0, 1, "feature"))
            if extent <= 0:
                diags.append(Diagnostic(
                    "error", "sharding", where, "unknown-dim",
                    f"claim on unknown grid dim {dim!r}",
                    "claim one of " + ", ".join(sorted(extents))))
                continue
            units = extent // quantum if quantum > 1 else extent
            if extent % max(1, quantum) != 0 or units % size != 0:
                if klass == "feature":
                    diags.append(Diagnostic(
                        "error", "sharding", where, "indivisible-claim",
                        f"dim {dim!r} (extent {extent}, quantum "
                        f"{quantum}) does not divide over "
                        f"{'x'.join(axes)}={size} — shards would split "
                        "mid-quantum",
                        "drop the claim (replicate) or choose a "
                        "dividing axis"))
                else:
                    # _claim_axis drops the claim at trace time; grouped
                    # ('pod','data') claims degrade suffix-first.
                    fallback = "replication"
                    for cut in range(1, len(axes)):
                        if extent % _size(mesh_axes, axes[cut:]) == 0:
                            fallback = f"axes {axes[cut:]}"
                            break
                    diags.append(Diagnostic(
                        "info", "sharding", where, "replication-fallback",
                        f"token dim {dim!r} (extent {extent}) does not "
                        f"divide {'x'.join(axes)}={size}; the wrapper "
                        f"degrades to {fallback} at trace time"))

        # Feature dims left unclaimed on a >1 model axis replicate — the
        # declared fallback; report reachability, never escalate.
        if model_size > 1 and stage in ("qkv", "attention", "decode_attn",
                                        "verify_attn", "ffn", "mixer"):
            if _reduction_claim(stage, choice) is None:
                diags.append(Diagnostic(
                    "info", "sharding", where, "replication-fallback",
                    f"stage has no tensor-parallel claim on the "
                    f"{model_size}-way model axis; it replicates "
                    "(never eager)"))

    # Psum coherence: the column-parallel qkv "out" claim and every
    # row-parallel consumer in the same layer must reduce over the SAME
    # axis — a different axis would psum over the wrong device groups.
    for kind, lp in plan.layers:
        out_ax = lp.qkv.claim("out") if lp.qkv.fused else None
        if out_ax is None:
            continue
        for stage, choice in lp.stages():
            if stage == "qkv" or not choice.fused:
                continue
            red = _reduction_claim(stage, choice)
            where = f"{kind}.{stage}"
            if red is None and stage in ("attention", "decode_attn",
                                         "verify_attn"):
                diags.append(Diagnostic(
                    "warning", "sharding", where, "implicit-regather",
                    f"qkv shards heads over {out_ax!r} but {stage} "
                    "carries no kv_heads claim — the head-sharded "
                    "projections are implicitly all-gathered",
                    "claim kv_heads on the same axis or drop the qkv "
                    "out claim"))
            elif red is not None and _axes_of(red) != _axes_of(out_ax):
                diags.append(Diagnostic(
                    "error", "sharding", where, "psum-mismatch",
                    f"column-parallel qkv reduces over {out_ax!r} but "
                    f"the row-parallel {stage} psums over {red!r} — "
                    "partial sums would combine across the wrong axis",
                    "use one tensor-parallel axis per layer"))
    return diags
