"""Piecewise-linear token behavior model — paper §5.3.1–5.3.3, Fig. 8.

A kernel that produces ``T`` tokens with initial delay ``D`` and pipeline
initiation interval ``II`` has the production curve

    produced(t) = clamp( floor((t - D) / II) + 1, 0, T )

measured from the kernel's own start.  A consumer started ``delay`` cycles
after the producer consumes with its own (D=0-at-pull, II) staircase.  The
token count resident in the connecting FIFO is ``produced(t) - consumed(t)``;
its maximum over time is the FIFO depth that guarantees the producer is never
back-pressured (paper Eqs. 1 and 2).

We provide both the paper's closed forms and an exact evaluation over the
staircase breakpoints (the maximum of a difference of staircases is attained
immediately after a producer push), which the test-suite cross-checks against
cycle-accurate simulation.

A copy of the reference's ``repro.core.token_model``, with the same names
and results.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Tuple

from .graph import KernelTiming


def produced_tokens(timing: KernelTiming, t: float, num_tokens: int) -> int:
    """Production staircase: tokens emitted by time ``t`` (kernel starts at 0)."""
    if t < timing.initial_delay:
        return 0
    k = math.floor((t - timing.initial_delay) / timing.pipeline_ii) + 1
    return max(0, min(num_tokens, int(k)))


def consumed_tokens(timing: KernelTiming, t: float, delay: float,
                    num_tokens: int) -> int:
    """Consumption staircase of a consumer started at ``delay``.

    The consumer pulls its first token the moment it starts (Fig. 8(a):
    Target consumes token0 at its start time) and then one token per ``II``.
    """
    if t < delay:
        return 0
    k = math.floor((t - delay) / timing.pipeline_ii) + 1
    return max(0, min(num_tokens, int(k)))


# --------------------------------------------------------------------- #
# Paper closed forms (Eqs. 1 and 2)
# --------------------------------------------------------------------- #

def max_tokens_eq1(source: KernelTiming, target: KernelTiming,
                   delay: float, num_tokens: int) -> int:
    """Eq. 1 — source throughput >= target throughput (Fig. 8(c))."""
    t = num_tokens
    return int(min(t, t - math.floor((source.latency - delay) / target.pipeline_ii)))


def max_tokens_eq2(source: KernelTiming, target: KernelTiming,
                   delay: float, num_tokens: int) -> int:
    """Eq. 2 — source throughput < target throughput (Fig. 8(d)/(e))."""
    t = num_tokens
    return int(min(t, math.ceil((delay - source.initial_delay)
                                / source.pipeline_ii)))


def max_tokens_paper(source: KernelTiming, target: KernelTiming,
                     delay: float, num_tokens: int) -> int:
    """Dispatch between Eq. 1 and Eq. 2 on relative throughput."""
    if source.pipeline_ii <= target.pipeline_ii:
        return max(1, max_tokens_eq1(source, target, delay, num_tokens))
    return max(1, max_tokens_eq2(source, target, delay, num_tokens))


# --------------------------------------------------------------------- #
# Exact staircase evaluation
# --------------------------------------------------------------------- #

def max_tokens_exact(source: KernelTiming, target: KernelTiming,
                     delay: float, num_tokens: int) -> int:
    """Exact maximum of produced(t) - consumed(t) over all t.

    The maximum of the staircase difference occurs immediately after one of
    the producer's pushes; push ``k`` happens at ``D_s + k*II_s``.  The
    difference as a function of ``k`` is piecewise monotone with a single
    regime change where the consumer starts, so it suffices to probe a small
    candidate set of pushes (plus both endpoints).
    """
    t = num_tokens
    if t <= 0:
        return 0
    d_s, ii_s = source.initial_delay, source.pipeline_ii
    candidates = {0, t - 1}
    # Push index at which the consumer has just started.
    if ii_s > 0:
        k_start = math.ceil((delay - d_s) / ii_s)
        for k in (k_start - 1, k_start, k_start + 1):
            if 0 <= k < t:
                candidates.add(int(k))
    best = 0
    for k in candidates:
        push_time = d_s + k * ii_s
        fifo = (k + 1) - consumed_tokens(target, push_time, delay, t)
        best = max(best, fifo)
    return min(t, max(1, best))


def simulate_fifo_occupancy(source: KernelTiming, target: KernelTiming,
                            delay: float, num_tokens: int,
                            ) -> Tuple[int, List[Tuple[float, int]]]:
    """Cycle-accurate (event-driven) FIFO occupancy trace, for verification.

    Returns (max_occupancy, [(time, occupancy_after_event), ...]).  This is
    the Fig. 8(a)/(b) board-level behavior and is used by tests to validate
    both the closed forms and the exact evaluation.
    """
    events: List[Tuple[float, int]] = []  # (time, +1 push / -1 pop)
    for k in range(num_tokens):
        events.append((source.initial_delay + k * source.pipeline_ii, +1))
        events.append((delay + k * target.pipeline_ii, -1))
    # At equal timestamps a pop frees its slot for the simultaneous push
    # (FIFOs support same-cycle read/write; this matches the paper's curve
    # difference model).  Early pops are deferred until a token exists.
    events.sort(key=lambda e: (e[0], e[1]))
    occ, max_occ, deferred = 0, 0, 0
    trace: List[Tuple[float, int]] = []
    for time, kind in events:
        if kind == +1:
            occ += 1
            if deferred and occ > 0:
                take = min(deferred, occ)
                occ -= take
                deferred -= take
        else:
            if occ > 0:
                occ -= 1
            else:
                deferred += 1  # consumer stalls waiting for a token
        max_occ = max(max_occ, occ)
        trace.append((time, occ))
    return max_occ, trace


# --------------------------------------------------------------------- #
# Equalization strategies (paper §5.3.3)
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class EqualizationStrategy:
    """'normal' keeps profiled IIs; 'conservative' scales every kernel's II to
    the slowest kernel's throughput, shrinking FIFO depths at the cost of
    latency (area/performance trade-off, paper §5.3.3)."""

    kind: str = "normal"

    def apply(self, timings: dict, num_tokens: dict) -> dict:
        if self.kind == "normal":
            return dict(timings)
        if self.kind != "conservative":
            raise ValueError(f"unknown equalization {self.kind}")
        slowest = max(t.pipeline_ii for t in timings.values())
        return {
            name: t.with_ii(slowest, num_tokens[name])
            for name, t in timings.items()
        }
