"""Lowering: fusion groups -> executable kernel implementations.

The final StreamTensor stages (Fig. 4: bufferization, HLS optimization, code
generation) retarget here: every fusion group is matched against a registry
of *fused kernel patterns*, each backed by a kernel module of
``repro_torch.kernels`` (a hand-written Hopper kernel with its plain PyTorch
version).  Groups that match no pattern lower to the framework default
(``"xla_fusion"``, the reference's name, kept so that summaries compare);
this mirrors the paper's fallback of passing unfused kernels to the vendor
compiler.

``compile_model`` is the one-call pipeline: trace -> tiling DSE -> fusion ->
FIFO sizing -> partition -> allocation -> lowering, returning a
``CompiledDataflow``.

A copy of the reference's ``repro.core.lowering``: each pattern names the
port's counterpart of the reference's kernel module
(``repro_torch.kernels.streamed_ffn`` for ``repro.kernels.streamed_ffn``,
...) under the reference's field name ``pallas_module``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..configs.base import ModelConfig
from .allocation import (H100_TIERS, AllocationResult, TPU_TIERS, allocate,
                         buffers_from_plan)
from .dse import (CostSource, DSEResult, TrialResult, evaluate_trial,
                  explore, modeled_latency_s)
from .fifo_sizing import FifoPlan
from .fusion import FusionPlan, fusion_memory_report
from .graph import DataflowGraph
from .partition import PartitionResult, partition
from .platforms import H100, Platform, TPU_V5E
from .trace import trace_block

# ---------------------------------------------------------------------- #
# Fused-kernel pattern registry
# ---------------------------------------------------------------------- #

@dataclass(frozen=True)
class KernelPattern:
    """A fused implementation available in ``repro_torch.kernels``.

    ``ops`` is the op-kind multiset the fusion group must cover (extra
    elementwise ops are absorbed into the fused kernel).
    """
    name: str
    ops: Tuple[str, ...]
    pallas_module: str
    priority: int = 0

    def matches(self, group_ops: Sequence[str]) -> bool:
        need = list(self.ops)
        for o in group_ops:
            if o in need:
                need.remove(o)
        return not need


PATTERNS: Tuple[KernelPattern, ...] = (
    KernelPattern("streamed_block", ("norm", "matmul", "attention", "matmul",
                                     "norm", "matmul", "matmul", "act_mul",
                                     "matmul"),
                  "repro_torch.kernels.streamed_ffn", priority=5),
    KernelPattern("flash_attention", ("attention",),
                  "repro_torch.kernels.flash_attention", priority=4),
    KernelPattern("streamed_ffn", ("matmul", "matmul", "act_mul", "matmul"),
                  "repro_torch.kernels.streamed_ffn", priority=4),
    KernelPattern("mamba2_scan", ("ssm_scan",),
                  "repro_torch.kernels.mamba2_scan", priority=4),
    KernelPattern("rwkv6_wkv", ("wkv6",),
                  "repro_torch.kernels.rwkv6_wkv", priority=4),
    KernelPattern("moe_experts", ("moe_experts",),
                  "repro_torch.kernels.moe_experts", priority=4),
    KernelPattern("rmsnorm_matmul", ("norm", "matmul"),
                  "repro_torch.kernels.rmsnorm_matmul", priority=3),
    KernelPattern("matmul_chain", ("matmul", "matmul"),
                  "repro_torch.kernels.streamed_ffn", priority=2),
    KernelPattern("matmul", ("matmul",),
                  "repro_torch.kernels.block_matmul", priority=1),
)


@dataclass
class LoweredGroup:
    group_index: int
    kernels: List[str]
    implementation: str          # pattern name or "xla_fusion"
    pallas_module: Optional[str]
    die: int = 0


def lower_groups(graph: DataflowGraph, fusion: FusionPlan,
                 part: Optional[PartitionResult] = None) -> List[LoweredGroup]:
    out: List[LoweredGroup] = []
    for gi, group in enumerate(fusion.groups):
        names = sorted(group, key=lambda n: graph.topo_order().index(n))
        ops = [graph.kernel(n).op for n in names]
        chosen: Optional[KernelPattern] = None
        for pat in sorted(PATTERNS, key=lambda p: -p.priority):
            if pat.matches(ops):
                chosen = pat
                break
        die = part.assignment[names[0]] if part else 0
        out.append(LoweredGroup(
            group_index=gi, kernels=names,
            implementation=chosen.name if chosen else "xla_fusion",
            pallas_module=chosen.pallas_module if chosen else None,
            die=die))
    return out


# ---------------------------------------------------------------------- #
# End-to-end compile
# ---------------------------------------------------------------------- #

@dataclass
class CompiledDataflow:
    """Everything the StreamTensor pipeline decided for one block graph."""
    arch: str
    platform: str
    graph: DataflowGraph
    trial: TrialResult
    fusion: FusionPlan
    fifo: FifoPlan
    partition: PartitionResult
    allocation: AllocationResult
    lowered: List[LoweredGroup]
    memory_report: Dict[str, float]
    stage_seconds: Dict[str, float]

    @property
    def latency_s(self) -> float:
        return self.trial.latency_s

    def summary(self) -> Dict[str, object]:
        return {
            "arch": self.arch,
            "platform": self.platform,
            "kernels": self.graph.num_kernels,
            "fusion_groups": self.fusion.num_groups,
            "onchip_bytes": self.trial.onchip_bytes,
            "external_bytes": self.trial.external_bytes,
            "memory_ratio": self.memory_report["ratio"],
            "fifo_total_depth": self.fifo.total_depth,
            "modeled_latency_s": self.latency_s,
            "implementations": [g.implementation for g in self.lowered],
        }


def compile_model(cfg: ModelConfig, *, tokens: int,
                  kv_len: Optional[int] = None,
                  platform: Platform = TPU_V5E,
                  layer_index: int = 0,
                  dse_budget: int = 12,
                  num_dies: int = 1,
                  strategy: str = "normal",
                  default_tile_size: Optional[int] = None,
                  overall_unroll_size: Optional[int] = None,
                  cost_source: Optional[CostSource] = None,
                  seed_trials: Optional[Sequence[Tuple[int, int]]] = None,
                  ) -> CompiledDataflow:
    """Run the full StreamTensor pipeline on one block of ``cfg``.

    With explicit ``default_tile_size``/``overall_unroll_size`` the DSE is
    skipped (single trial) — used by tests and ablations; otherwise the
    blackbox explorer searches the tiling space with fusion feedback.
    ``cost_source`` swaps the DSE's kernel-latency oracle (analytic |
    measured | hybrid, see ``dse.CostSource``); ``seed_trials`` warm-start
    the explorer deterministically.
    """
    stages: Dict[str, float] = {}
    t0 = time.perf_counter()
    ops = trace_block(cfg, tokens=tokens, kv_len=kv_len,
                      layer_index=layer_index)
    stages["trace"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if default_tile_size is not None:
        trial = evaluate_trial(ops, platform, default_tile_size,
                               overall_unroll_size or 64,
                               strategy=strategy, keep_artifacts=True,
                               cost_source=cost_source)
    else:
        trial = explore(ops, platform, budget=dse_budget,
                        strategy=strategy, cost_source=cost_source,
                        seed_trials=seed_trials).best
    stages["dse+fusion+fifo"] = time.perf_counter() - t0
    assert trial.graph is not None and trial.fusion is not None
    assert trial.fifo is not None

    t0 = time.perf_counter()
    part = partition(trial.graph, num_dies)
    stages["partition"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    bufs = buffers_from_plan(trial.graph, trial.fusion, trial.fifo)
    # The Hopper card allocates over its own tiers; the reference's four
    # platforms over the TPU tiers, as the reference does for every one.
    alloc = allocate(bufs, H100_TIERS if platform == H100 else TPU_TIERS)
    stages["allocation"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lowered = lower_groups(trial.graph, trial.fusion, part)
    stages["lowering"] = time.perf_counter() - t0

    report = fusion_memory_report(trial.graph, trial.fusion)
    return CompiledDataflow(
        arch=cfg.name, platform=platform.name, graph=trial.graph,
        trial=trial, fusion=trial.fusion, fifo=trial.fifo, partition=part,
        allocation=alloc, lowered=lowered, memory_report=report,
        stage_seconds=stages)
