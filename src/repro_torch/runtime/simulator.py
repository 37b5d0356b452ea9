"""Discrete-event simulator for self-timed dataflow graphs.

Plays the role of the paper's on-board measurement: kernels fire when their
input FIFOs hold tokens and their output FIFOs have space (back-pressure), so
undersized FIFOs manifest as stall cascades — and, for window-consuming
kernels such as layout converters, as outright deadlock (paper Pitfall 4).
The test-suite uses this to validate that LP-sized FIFO plans complete
stall-free and that deliberately undersized ones deadlock.

Model (multi-rate synchronous dataflow):
  * A kernel with timing (D, II) fires its first token D cycles after its
    inputs for that firing are present, and subsequent tokens II cycles
    apart (or later, if starved or back-pressured).
  * Rates: the tokens on an edge are the PRODUCER's tokens.  A consumer
    making ``T_c`` firings against a producer stream of ``T_p`` tokens
    consumes ``floor((f+1)*T_p/T_c) - floor(f*T_p/T_c)`` tokens on its f-th
    firing (rational-rate SDF) — this is how kernels with different tile
    granularities compose, mirroring the itensor reassociation at stream
    boundaries.
  * ``consume_window[k] = w`` marks kernel ``k`` as a window consumer: its
    first firing additionally requires ``w`` tokens resident in each input
    FIFO — the behavior of a stream layout converter that must fill its
    ping buffer before emitting (paper §3.2.1 itensor_converter).

A copy of the reference's ``repro.runtime.simulator``, with the same names
and results.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.fifo_sizing import FifoPlan
from ..core.graph import DataflowGraph, KernelTiming

EdgeKey = Tuple[str, str, int]


@dataclass
class SimResult:
    completed: bool
    makespan: float
    fired: Dict[str, int]
    peak_occupancy: Dict[EdgeKey, int]
    deadlock_kernels: List[str] = field(default_factory=list)

    def throughput(self, tokens: int) -> float:
        return tokens / self.makespan if self.makespan > 0 else 0.0


def simulate_dataflow(
    graph: DataflowGraph,
    timings: Dict[str, KernelTiming],
    plan: Optional[FifoPlan] = None,
    depths: Optional[Dict[EdgeKey, int]] = None,
    consume_window: Optional[Dict[str, int]] = None,
    max_steps: int = 1_000_000,
) -> SimResult:
    """Run the graph to completion or deadlock.

    Args:
        graph: dataflow graph; each kernel fires ``out_type.num_tokens`` times.
        timings: per-kernel (L, D, II).
        plan: FIFO plan providing per-edge depths (preferred).
        depths: explicit per-edge depth override (used to provoke deadlock).
        consume_window: first-firing window requirement per kernel.
    """
    cap: Dict[EdgeKey, int] = {}
    for u, v, k, _ in graph.edges():
        key = (u, v, k)
        if depths and key in depths:
            cap[key] = depths[key]
        elif plan is not None:
            cap[key] = plan.depths[key]
        else:
            cap[key] = 2
    window = consume_window or {}

    in_edges: Dict[str, List[EdgeKey]] = {n: [] for n in graph.g.nodes}
    out_edges: Dict[str, List[EdgeKey]] = {n: [] for n in graph.g.nodes}
    for u, v, k, _ in graph.edges():
        in_edges[v].append((u, v, k))
        out_edges[u].append((u, v, k))

    fifo: Dict[EdgeKey, deque] = {e: deque() for e in cap}
    peak: Dict[EdgeKey, int] = {e: 0 for e in cap}
    target = {n: graph.kernel(n).num_out_tokens for n in graph.g.nodes}
    fired = {n: 0 for n in graph.g.nodes}
    last_fire = {n: -float("inf") for n in graph.g.nodes}
    makespan = 0.0

    # Rational-rate consumption: tokens the consumer of edge e pops on its
    # f-th firing (producer stream length vs consumer firing count).
    def edge_need(e: EdgeKey, f: int) -> int:
        u, v, _ = e
        tp, tc = target[u], target[v]
        return (f + 1) * tp // tc - f * tp // tc

    def fire_time(n: str) -> Optional[float]:
        """Earliest time kernel n can fire its next token, or None."""
        if fired[n] >= target[n]:
            return None
        f = fired[n]
        arrivals = []
        for e in in_edges[n]:
            need = edge_need(e, f)
            if f == 0:
                need = max(need, window.get(n, 1) if need else 0)
            if len(fifo[e]) < need:
                return None  # starved
            if need:
                arrivals.append(fifo[e][need - 1])
        for e in out_edges[n]:
            if len(fifo[e]) >= cap[e]:
                return None  # back-pressured
        t = timings[n]
        pipeline = (t.initial_delay if f == 0 else
                    last_fire[n] + t.pipeline_ii)
        base = max(arrivals) if arrivals else 0.0
        if f == 0:
            return max(base + t.initial_delay,
                       pipeline if not in_edges[n] else 0.0)
        return max(base, pipeline)

    steps = 0
    while steps < max_steps:
        steps += 1
        best_n, best_t = None, None
        for n in graph.g.nodes:
            ft = fire_time(n)
            if ft is not None and (best_t is None or ft < best_t):
                best_n, best_t = n, ft
        if best_n is None:
            break
        # Fire best_n at best_t: pop its rate per input, push per output.
        f = fired[best_n]
        for e in in_edges[best_n]:
            for _ in range(edge_need(e, f)):
                fifo[e].popleft()
        for e in out_edges[best_n]:
            fifo[e].append(best_t)
            peak[e] = max(peak[e], len(fifo[e]))
        fired[best_n] += 1
        last_fire[best_n] = best_t
        makespan = max(makespan, best_t)

    incomplete = [n for n in graph.g.nodes if fired[n] < target[n]]
    return SimResult(
        completed=not incomplete,
        makespan=makespan,
        fired=fired,
        peak_occupancy=peak,
        deadlock_kernels=incomplete,
    )
