"""LP-based FIFO sizing — paper §5.3.4, Eqs. 3–5.

The token behavior model turns FIFO sizing into choosing the inter-kernel
start ``delay`` values: a FIFO of depth ``max_tokens(delay)`` never
back-pressures its producer, so the dataflow accelerator runs stall-free and
deadlock-free.  The paper minimizes the sum of edge delays subject to, for
every kernel pair, every path's delay-sum exceeding the largest accumulated
initial delay over all paths between the pair (Eqs. 4–5).

Physically every kernel has a single start time, so edge delays telescope:
``delay(i,j) = s(j) - s(i)``.  Under this (physically forced) consistency the
LP reduces to the longest-path problem ``s(v) = max_{u->v} s(u) + D(u)``,
which we solve exactly by DP over the DAG.  The test-suite cross-checks the DP
against ``scipy.optimize.linprog`` on the compact LP and against brute-force
path enumeration of the paper's original formulation on small random DAGs.

A copy of the reference's ``repro.core.fifo_sizing``, with the same names
and results.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import networkx as nx

from .graph import DataflowGraph, KernelTiming
from .token_model import EqualizationStrategy, max_tokens_exact, max_tokens_paper


@dataclass
class FifoPlan:
    """Sized FIFOs for every stream edge.

    Attributes:
        start_times: kernel -> optimal start time ``s(v)`` (cycles).
        delays: edge (u, v, key) -> delay value used for sizing.
        depths: edge -> FIFO depth in tokens.
        fifo_bytes: edge -> memory cost (depth * token bytes).
        strategy: equalization strategy used.
    """

    start_times: Dict[str, float]
    delays: Dict[Tuple[str, str, int], float]
    depths: Dict[Tuple[str, str, int], int]
    fifo_bytes: Dict[Tuple[str, str, int], float]
    strategy: str

    @property
    def total_bytes(self) -> float:
        return sum(self.fifo_bytes.values())

    @property
    def total_depth(self) -> int:
        return sum(self.depths.values())


def solve_start_times(graph: DataflowGraph,
                      timings: Dict[str, KernelTiming]) -> Dict[str, float]:
    """Optimal start times: longest accumulated-D path from the sources.

    This is the exact optimum of the paper's LP restricted to consistent
    (single-start-time) delays; see module docstring.
    """
    s: Dict[str, float] = {}
    for n in graph.topo_order():
        best = 0.0
        for p in graph.predecessors(n):
            best = max(best, s[p] + timings[p].initial_delay)
        s[n] = best
    return s


def size_fifos(
    graph: DataflowGraph,
    timings: Dict[str, KernelTiming],
    strategy: str = "normal",
    use_exact_curves: bool = True,
) -> FifoPlan:
    """Solve the FIFO sizing problem for every edge of ``graph``.

    Args:
        graph: dataflow graph (typically one fusion group).
        timings: per-kernel (L, D, II) — profiled or modelled.
        strategy: 'normal' or 'conservative' equalization (paper §5.3.3).
        use_exact_curves: size with the exact staircase maximum instead of the
            closed forms (both are available; exact is never smaller than
            required and is what we deploy).
    """
    tokens = {k.name: k.num_out_tokens for k in graph.kernels()}
    eq = EqualizationStrategy(strategy)
    eq_timings = eq.apply(timings, tokens)

    start = solve_start_times(graph, eq_timings)
    delays: Dict[Tuple[str, str, int], float] = {}
    depths: Dict[Tuple[str, str, int], int] = {}
    fifo_bytes: Dict[Tuple[str, str, int], float] = {}

    size_fn = max_tokens_exact if use_exact_curves else max_tokens_paper
    for u, v, key, data in graph.edges():
        delay = start[v] - start[u]
        # The number of tokens crossing this edge is the producer stream
        # length (paper: T is inferred statically from tensor shapes).
        t = data["src_type"].num_tokens
        # Multi-rate extension (beyond the paper's 1:1 token assumption):
        # a consumer firing T_c times against T_p producer tokens pulls at
        # an effective II of II_c * T_c / T_p per producer token.
        tc = tokens[v]
        cons = eq_timings[v]
        if tc != t and t > 0:
            cons = KernelTiming.from_tokens(
                cons.initial_delay, cons.pipeline_ii * tc / t, t)
        depth = size_fn(eq_timings[u], cons, delay, t)
        depth = max(2, depth)  # ping/pong minimum so producer never blocks
        if tc and t > tc:
            depth = max(depth, -(-t // tc))   # one whole firing's pop fits
        delays[(u, v, key)] = delay
        depths[(u, v, key)] = depth
        fifo_bytes[(u, v, key)] = depth * data["src_type"].token_bytes
    return FifoPlan(start_times=start, delays=delays, depths=depths,
                    fifo_bytes=fifo_bytes, strategy=strategy)


# --------------------------------------------------------------------- #
# Reference LP solvers (verification only)
# --------------------------------------------------------------------- #

def solve_lp_scipy(graph: DataflowGraph,
                   timings: Dict[str, KernelTiming]) -> Optional[Dict[str, float]]:
    """Compact LP with start-time variables, solved by scipy (tests only).

    minimize   sum_{(i,j) in E} (s_j - s_i)
    subject to s_j - s_i >= D_i             for every edge (i, j)
               s_root = 0                   for source kernels
    """
    try:
        from scipy.optimize import linprog
    except ImportError:
        return None

    nodes = list(graph.g.nodes)
    idx = {n: i for i, n in enumerate(nodes)}
    n_var = len(nodes)
    # Objective: for each edge (i, j): +1 on s_j, -1 on s_i.
    c = [0.0] * n_var
    for u, v, k, _ in graph.edges():
        c[idx[v]] += 1.0
        c[idx[u]] -= 1.0
    a_ub: List[List[float]] = []
    b_ub: List[float] = []
    for u, v, k, _ in graph.edges():
        row = [0.0] * n_var
        row[idx[u]] = 1.0
        row[idx[v]] = -1.0     # s_u - s_v <= -D_u
        a_ub.append(row)
        b_ub.append(-timings[u].initial_delay)
    res = linprog(c, A_ub=a_ub, b_ub=b_ub, bounds=[(0, None)] * n_var,
                  method="highs")
    if not res.success:
        return None
    return {n: float(res.x[idx[n]]) for n in nodes}


def paper_lp_thresholds(graph: DataflowGraph,
                        timings: Dict[str, KernelTiming]) -> Dict[Tuple[str, str], float]:
    """Eq. 5: threshold(u, v) = max over paths of accumulated D, for tests."""
    out: Dict[Tuple[str, str], float] = {}
    nodes = list(graph.g.nodes)
    for u in nodes:
        for v in nodes:
            if u == v:
                continue
            best = None
            for path in nx.all_simple_paths(graph.g, u, v):
                acc = sum(timings[p].initial_delay for p in path[:-1])
                best = acc if best is None else max(best, acc)
            if best is not None:
                out[(u, v)] = best
    return out


def verify_plan_against_paper_lp(graph: DataflowGraph,
                                 timings: Dict[str, KernelTiming],
                                 plan: FifoPlan) -> bool:
    """Check plan delays satisfy the paper's path constraints (Eq. 4)."""
    thresholds = paper_lp_thresholds(graph, timings)
    for (u, v), thr in thresholds.items():
        for path in nx.all_simple_paths(graph.g, u, v):
            acc = 0.0
            for a, b in zip(path, path[1:]):
                key = next(iter(graph.g[a][b]))
                acc += plan.delays[(a, b, key)]
            if acc + 1e-9 < thr:
                return False
    return True
