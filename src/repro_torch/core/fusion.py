"""Dataflow kernel fusion exploration — paper §5.2.2, Algorithm 2.

Fusion enables on-chip streaming between kernels.  The itensor type system
makes *any* producer/consumer pair fuseable by design — at the on-chip memory
cost of a layout converter when types mismatch (Algorithm 1).  Given the cost
of every edge, Algorithm 2 greedily partitions the kernel graph, in
topological order, into fusion groups whose accumulated cost stays below
``c_max`` (the single-device on-chip budget: BRAM+URAM on the paper's FPGA,
VMEM on the reference's TPU target).

The algorithm is reproduced faithfully, including the sentinel empty group at
index 0 and the fuse-with-the-*nearest*-candidate rule (``max(cand.keys())`` —
the most recently opened group among the predecessors' groups).

A copy of the reference's ``repro.core.fusion``, with the same names
and results.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .graph import DataflowGraph

CostFn = Callable[[DataflowGraph, str, str, int], float]


def _default_edge_cost(graph: DataflowGraph, u: str, v: str, key: int) -> float:
    return graph.edge_memory_cost(u, v, key)


@dataclass
class FusionPlan:
    """Result of fusion exploration.

    Attributes:
        groups: list of kernel-name sets; ``groups[i]`` is fusion group ``i``.
            (The paper's sentinel empty set is removed.)
        costs: on-chip memory cost accumulated by each group.
        index: kernel name -> group index.
    """

    groups: List[Set[str]]
    costs: List[float]
    index: Dict[str, int]

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def group_of(self, name: str) -> int:
        return self.index[name]

    def intra_edges(self, graph: DataflowGraph) -> List[Tuple[str, str, int]]:
        out = []
        for u, v, k, _ in graph.edges():
            if self.index[u] == self.index[v]:
                out.append((u, v, k))
        return out

    def inter_edges(self, graph: DataflowGraph) -> List[Tuple[str, str, int]]:
        out = []
        for u, v, k, _ in graph.edges():
            if self.index[u] != self.index[v]:
                out.append((u, v, k))
        return out

    def external_bytes(self, graph: DataflowGraph) -> float:
        """External-memory traffic crossing group boundaries (DMA tensors)."""
        return sum(graph.g.edges[u, v, k]["src_type"].data_bytes
                   for u, v, k in self.inter_edges(graph))


def explore_fusion(
    graph: DataflowGraph,
    c_max: float,
    edge_cost: CostFn = _default_edge_cost,
    node_cost: Optional[Callable[[DataflowGraph, str], float]] = None,
) -> FusionPlan:
    """Algorithm 2 (paper §5.2.2), faithful reproduction.

    Args:
        graph: the kernel dataflow graph.
        c_max: maximum on-chip memory one fused kernel may use.
        edge_cost: ``compute_memory_cost`` — converter + FIFO bytes of fusing
            across an edge (defaults to the Algorithm-1-based cost).
        node_cost: optional extension beyond the paper — adds each kernel's own
            on-chip footprint to its group's budget.  ``None`` reproduces the
            paper exactly (edge costs only).
    """
    F: List[Set[str]] = [set()]   # sentinel empty fusion, as in the paper
    C: List[float] = [0.0]
    M: Dict[str, int] = {}

    for n in graph.topo_order():
        cand: Dict[int, float] = {}
        for p in graph.predecessors(n):
            # Sum cost over all parallel operand edges p -> n.
            for key in graph.g[p][n]:
                cost = edge_cost(graph, p, n, key)
                cand[M[p]] = cand.get(M[p], 0.0) + cost

        f_idx, f_cost = len(F), 0.0
        if cand:
            f_idx = max(cand.keys())          # fuse with the nearest candidate
            f_cost = cand[f_idx]
        extra = node_cost(graph, n) if node_cost else 0.0

        if f_idx == len(F) or f_cost + extra + C[f_idx] > c_max:
            F.append({n})
            C.append(extra)
            M[n] = len(F) - 1
        else:
            F[f_idx].add(n)
            C[f_idx] += f_cost + extra
            M[n] = f_idx
        graph.g.nodes[n]["fusion_index"] = M[n]

    # Drop the sentinel and renumber densely.
    keep = [i for i, s in enumerate(F) if s]
    renum = {old: new for new, old in enumerate(keep)}
    groups = [F[i] for i in keep]
    costs = [C[i] for i in keep]
    index = {n: renum[i] for n, i in M.items()}
    for n, i in index.items():
        graph.g.nodes[n]["fusion_index"] = i
    return FusionPlan(groups=groups, costs=costs, index=index)


def fusion_memory_report(graph: DataflowGraph, plan: FusionPlan) -> Dict[str, float]:
    """Before/after on-chip memory for the Fig. 10a study.

    'Before' = every intermediate result held in a full on-chip buffer (the
    only way to run fully on-chip without streaming fusion).  'After' =
    converters + FIFOs of the fused design.
    """
    before = graph.intermediate_bytes_unfused()
    after = graph.intermediate_bytes_fused(plan.index)
    return {
        "before_bytes": before,
        "after_bytes": after,
        "ratio": after / before if before else 0.0,
        "num_groups": plan.num_groups,
        "external_bytes": plan.external_bytes(graph),
    }
