"""Design-space exploration — paper §5.1 (Optuna stand-in) + §5.

StreamTensor explores three hierarchical spaces:

  1. **Tiling space** (``tiling.py``) — hyperparameters ``default_tile_size``
     and ``overall_unroll_size``, explored here by a blackbox optimizer with
     *feedback from the kernel fusion results* (the paper uses Optuna; we ship
     an offline random + coordinate-hill-climb explorer with the same
     interface and objective).
  2. **Fusion space** (``fusion.py``) — Algorithm 2 under ``C_max``.
  3. **Resource allocation space** (``fifo_sizing.py``/``partition.py``/
     ``allocation.py``) — FIFO depths via the LP, die partitioning, tiers.

The objective evaluated per trial runs spaces 2 and 3 end-to-end and scores
the result, exactly the feedback loop of Fig. 4:

    score = modeled end-to-end latency (dataflow makespan + DMA traffic time)
            + infeasibility penalties (a kernel alone exceeding C_max feeds
              back "reduce tiling/unroll", paper §5.2.2)

A copy of the reference's ``repro.core.dse``, with the same names
and results.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .fifo_sizing import FifoPlan, size_fifos, solve_start_times
from .fusion import FusionPlan, explore_fusion
from .graph import DataflowGraph
from .platforms import Platform
from .tiling import LinalgOpSpec, TilingSpace


@dataclass(frozen=True)
class CostSource:
    """Pluggable kernel-latency oracle for the DSE objective (§16).

    The analytic objective models every kernel's latency from the (L, D,
    II) platform model; a measured source overrides those terms with
    wall-clock numbers from the autotuner's table:

      * ``mode="analytic"`` — the FPGA-era model, unchanged (default).
      * ``mode="measured"`` — ``lookup(kernel_name) -> seconds | None``
        overrides where it answers; unknown kernels keep the analytic
        term (and are reported as such in the trial breakdown).
      * ``mode="hybrid"``   — like measured, but a miss is filled by
        ``fill(kernel_name, analytic_seconds) -> seconds`` (the tuning
        layer's measure-and-cache callback) instead of falling back.
    """
    mode: str = "analytic"
    lookup: Optional[Callable[[str], Optional[float]]] = None
    fill: Optional[Callable[[str, float], float]] = None

    def __post_init__(self) -> None:
        if self.mode not in ("analytic", "measured", "hybrid"):
            raise ValueError(f"unknown CostSource mode {self.mode!r} "
                             "(analytic | measured | hybrid)")

    def kernel_seconds(self, name: str,
                       analytic_s: float) -> Tuple[float, str]:
        """(latency seconds, provenance) for one kernel."""
        if self.mode == "analytic" or self.lookup is None:
            return analytic_s, "analytic"
        got = self.lookup(name)
        if got is not None:
            return float(got), "measured"
        if self.mode == "hybrid" and self.fill is not None:
            return float(self.fill(name, analytic_s)), "measured"
        return analytic_s, "analytic"


ANALYTIC = CostSource()


@dataclass
class TrialResult:
    params: Dict[str, int]
    score: float
    latency_s: float
    onchip_bytes: float
    external_bytes: float
    num_groups: int
    feasible: bool
    graph: Optional[DataflowGraph] = None
    fusion: Optional[FusionPlan] = None
    fifo: Optional[FifoPlan] = None
    # Per-kernel timing terms of the makespan objective: kernel name ->
    # {"start_s", "kernel_s", "source"} — the DSE's audit trail (§16).
    breakdown: Dict[str, Dict[str, object]] = field(default_factory=dict)
    dma_s: float = 0.0
    cost_source: str = "analytic"


@dataclass
class DSEResult:
    best: TrialResult
    trials: List[TrialResult]
    # Deterministic warm-start points evaluated before random sampling —
    # recorded so a tuned plan's provenance names the seeds it ran under.
    seed_trials: Tuple[Tuple[int, int], ...] = ()

    @property
    def num_trials(self) -> int:
        return len(self.trials)

    @property
    def breakdowns(self) -> List[Dict[str, Dict[str, object]]]:
        """Per-trial timing breakdowns, in score order."""
        return [t.breakdown for t in self.trials]


def latency_breakdown(graph: DataflowGraph, fusion: FusionPlan,
                      fifo: FifoPlan, platform: Platform,
                      cost_source: Optional[CostSource] = None,
                      ) -> Tuple[float, Dict[str, Dict[str, object]],
                                 float]:
    """End-to-end latency of the fused design plus its per-kernel terms.

    Dataflow makespan = max over kernels of (LP start time + kernel
    latency); inter-group edges round-trip external memory and are
    charged at HBM bandwidth (exactly what stream fusion removes).  The
    kernel-latency term goes through ``cost_source`` so the same LP
    machinery scores analytic, measured, and hybrid objectives.
    Returns ``(latency_s, per-kernel breakdown, dma_s)``.
    """
    cs = cost_source or ANALYTIC
    makespan_s = 0.0
    breakdown: Dict[str, Dict[str, object]] = {}
    for k in graph.kernels():
        t = k.timing
        if t is None:
            continue
        kernel_s, src = cs.kernel_seconds(k.name,
                                          platform.seconds(t.latency))
        start_s = platform.seconds(fifo.start_times[k.name])
        breakdown[k.name] = {"start_s": start_s, "kernel_s": kernel_s,
                             "source": src}
        makespan_s = max(makespan_s, start_s + kernel_s)
    dma_bytes = fusion.external_bytes(graph) * 2.0   # write + read back
    dma_bytes += graph.total_weight_bytes()
    dma_s = dma_bytes / platform.hbm_bw
    return makespan_s + dma_s, breakdown, dma_s


def modeled_latency_s(graph: DataflowGraph, fusion: FusionPlan,
                      fifo: FifoPlan, platform: Platform,
                      cost_source: Optional[CostSource] = None) -> float:
    """Analytic (or cost-source-overridden) end-to-end latency."""
    return latency_breakdown(graph, fusion, fifo, platform,
                             cost_source)[0]


def evaluate_trial(ops: Sequence[LinalgOpSpec], platform: Platform,
                   default_tile_size: int, overall_unroll_size: int,
                   c_max: Optional[float] = None,
                   strategy: str = "normal",
                   keep_artifacts: bool = False,
                   cost_source: Optional[CostSource] = None) -> TrialResult:
    """One full pass through fusion + FIFO sizing (spaces 2 and 3)."""
    params = {"default_tile_size": default_tile_size,
              "overall_unroll_size": overall_unroll_size}
    c_max = c_max if c_max is not None else platform.fusion_budget()
    space = TilingSpace(ops=list(ops), default_tile_size=default_tile_size,
                        overall_unroll_size=overall_unroll_size)
    graph = space.build_graph(platform)

    def node_cost(g: DataflowGraph, name: str) -> float:
        return g.kernel(name).local_bytes

    fusion = explore_fusion(graph, c_max, node_cost=node_cost)
    timings = {k.name: k.timing for k in graph.kernels()}
    fifo = size_fifos(graph, timings, strategy=strategy)

    onchip = sum(fusion.costs) + fifo.total_bytes
    feasible = all(c <= c_max for c in fusion.costs)
    latency, breakdown, dma_s = latency_breakdown(
        graph, fusion, fifo, platform, cost_source)
    # Infeasibility: a single kernel exceeding C_max must shrink its tiling
    # (paper §5.2.2 feedback); penalize proportionally so the explorer walks
    # back toward smaller tiles/unrolls.
    penalty = 0.0
    if not feasible:
        worst = max(fusion.costs)
        penalty = latency * (worst / c_max)
    return TrialResult(
        params=params, score=latency + penalty, latency_s=latency,
        onchip_bytes=onchip, external_bytes=fusion.external_bytes(graph),
        num_groups=fusion.num_groups, feasible=feasible,
        graph=graph if keep_artifacts else None,
        fusion=fusion if keep_artifacts else None,
        fifo=fifo if keep_artifacts else None,
        breakdown=breakdown, dma_s=dma_s,
        cost_source=(cost_source or ANALYTIC).mode)


def explore(ops: Sequence[LinalgOpSpec], platform: Platform,
            c_max: Optional[float] = None,
            tile_candidates: Sequence[int] = (16, 32, 64, 128, 256),
            unroll_candidates: Sequence[int] = (8, 16, 32, 64, 128, 256),
            budget: int = 24, seed: int = 0,
            strategy: str = "normal",
            cost_source: Optional[CostSource] = None,
            seed_trials: Optional[Sequence[Tuple[int, int]]] = None
            ) -> DSEResult:
    """Blackbox exploration (Optuna stand-in): seeded random sampling over the
    log-2 lattice followed by coordinate hill-climbing around the incumbent.

    ``seed_trials`` are (tile, unroll) points evaluated deterministically
    BEFORE random sampling — pass the winning params of a previous run to
    make a tuned plan reproducible given a frozen table: the warm starts
    are scored first, count against the budget, and on a score tie the
    earliest trial wins, so a frozen table replays to the same plan.
    """
    rng = random.Random(seed)
    seen: Dict[Tuple[int, int], TrialResult] = {}
    order: List[Tuple[int, int]] = []

    def run(ts: int, us: int) -> TrialResult:
        key = (ts, us)
        if key not in seen:
            seen[key] = evaluate_trial(ops, platform, ts, us, c_max=c_max,
                                       strategy=strategy,
                                       cost_source=cost_source)
            order.append(key)
        return seen[key]

    # Phase 0: deterministic warm starts.
    warm: Tuple[Tuple[int, int], ...] = tuple(
        (int(ts), int(us)) for ts, us in (seed_trials or ()))
    for ts, us in warm:
        run(ts, us)

    # Phase 1: random sampling (half the budget).
    lattice = [(t, u) for t in tile_candidates for u in unroll_candidates]
    rng.shuffle(lattice)
    for ts, us in lattice[:max(1, budget // 2)]:
        if len(seen) >= max(budget, len(warm)):
            break
        run(ts, us)

    # Phase 2: coordinate hill-climb around the incumbent.
    def neighbors(ts: int, us: int) -> List[Tuple[int, int]]:
        ti = tile_candidates.index(ts) if ts in tile_candidates else 0
        ui = unroll_candidates.index(us) if us in unroll_candidates else 0
        out = []
        for di in (-1, 1):
            if 0 <= ti + di < len(tile_candidates):
                out.append((tile_candidates[ti + di], us))
            if 0 <= ui + di < len(unroll_candidates):
                out.append((ts, unroll_candidates[ui + di]))
        return out

    while len(seen) < budget:
        inc = min(seen.values(), key=lambda r: r.score)
        moves = [n for n in neighbors(*inc.params.values()) if n not in seen]
        if not moves:
            break
        run(*moves[0])

    # Stable sort on score alone: ties resolve to the earliest-evaluated
    # trial, which is what makes seed_trials deterministic warm starts.
    rank = {key: i for i, key in enumerate(order)}
    trials = sorted(seen.values(),
                    key=lambda r: (r.score,
                                   rank[tuple(r.params.values())]))
    best = trials[0]
    # Re-run the winner keeping artifacts for downstream lowering.
    best = evaluate_trial(ops, platform, **best.params, c_max=c_max,
                          strategy=strategy, keep_artifacts=True,
                          cost_source=cost_source)
    return DSEResult(best=best, trials=trials, seed_trials=warm)
