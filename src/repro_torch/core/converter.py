"""Stream layout converter generation — paper §5.2.1, Algorithm 1.

When a producer's output itensor type differs from the consumer's input type,
a converter with a local ping-pong buffer re-orders the stream on the fly.
Algorithm 1 infers the *minimal* ping-pong buffer analytically from the two
itensor types.

We implement the algorithm in its semantic form: find the maximal *outermost
shared loop prefix* of the two iteration spaces (equal trip counts, equal
steps, feeding the same data dim with equal element extents — or both being
reuse dims).  Data dims fed by shared-prefix loops only need one element
extent of buffering (the buffer is re-used across those loops, paper §4.3.1);
every other data dim must be buffered at full extent, because within one
shared-prefix iteration the two streams may touch its tiles in arbitrary
relative order.

This reproduces the paper's Fig. 5 worked example exactly: converting
itensor(b) -> itensor(c) shares only loop d0 (feeding the second data dim), so
the window is ``8x2`` (two 4x2 tiles), doubled to four tiles by ping-ponging.

``min_buffer_tiles_sim`` computes the true minimum by stream simulation and is
used by the test-suite (hypothesis) to check that the analytic window is always
sufficient and is tight on aligned layouts.

A copy of the reference's ``repro.core.converter``, with the same names
and results.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .itensor import ITensorType, dtype_bytes


@dataclass(frozen=True)
class ConverterSpec:
    """Result of Algorithm 1.

    Attributes:
        buf_shape: logical window shape in data elements (before ping-pong).
        shared_prefix_len: paper's ``beforeLoop`` — number of outermost loops
            shared by producer and consumer; the buffer is inserted below them
            and re-used once per shared iteration.
        reuse_count: how many times the window buffer is re-used
            (= product of shared-prefix trip counts).
        dtype: element dtype.
    """

    buf_shape: Tuple[int, ...]
    shared_prefix_len: int
    reuse_count: int
    dtype: str

    @property
    def window_bytes(self) -> float:
        return math.prod(self.buf_shape) * dtype_bytes(self.dtype)

    @property
    def pingpong_bytes(self) -> float:
        """On-chip memory cost: ping + pong copies of the window."""
        return 2.0 * self.window_bytes

    def window_tiles(self, elem_shape: Sequence[int]) -> int:
        return int(math.prod(self.buf_shape) // max(1, math.prod(elem_shape)))


def _loop_feeds(t: ITensorType) -> Dict[int, int]:
    """Map loop position -> data dim it feeds (reuse loops absent)."""
    return {p: j for j, p in enumerate(t.iter_map.results)}


def shared_prefix_length(src: ITensorType, res: ITensorType) -> int:
    """Maximal outermost loop prefix shared by the two iteration spaces."""
    src_feed, res_feed = _loop_feeds(src), _loop_feeds(res)
    m = 0
    for p in range(min(src.iter_rank, res.iter_rank)):
        if src.tripcounts[p] != res.tripcounts[p]:
            break
        sj, rj = src_feed.get(p), res_feed.get(p)
        if sj != rj:
            break  # feed different data dims, or reuse-vs-data mismatch
        if src.steps[p] != res.steps[p]:
            break
        if sj is not None and src.elem_shape[sj] != res.elem_shape[sj]:
            break
        m += 1
    return m


def infer_converter(src: ITensorType, res: ITensorType) -> Optional[ConverterSpec]:
    """Algorithm 1: minimal ping-pong buffer for a src -> res layout conversion.

    Returns ``None`` when the types already match (no converter required).
    Raises if the conversion is impossible (different data space or dtype).
    """
    if src.dtype != res.dtype:
        raise ValueError(f"dtype mismatch: {src.dtype} vs {res.dtype}")
    if src.data_shape != res.data_shape:
        raise ValueError(
            f"data space mismatch: {src.data_shape} vs {res.data_shape}")
    if src.canonicalize() == res.canonicalize():
        return None

    m = shared_prefix_length(src, res)
    src_results = src.iter_map.results
    buf_shape = tuple(
        src.elem_shape[j] if src_results[j] < m else src.data_shape[j]
        for j in range(src.rank)
    )
    reuse = math.prod(src.tripcounts[:m]) if m else 1
    return ConverterSpec(
        buf_shape=buf_shape,
        shared_prefix_len=m,
        reuse_count=int(reuse),
        dtype=src.dtype,
    )


def conversion_cost_bytes(src: ITensorType, res: ITensorType) -> float:
    """On-chip bytes required to fuse ``src -> res`` (0 when types match)."""
    spec = infer_converter(src, res)
    return 0.0 if spec is None else spec.pingpong_bytes


def fusion_verdict(src: ITensorType, res: ITensorType) -> str:
    """Classify producer -> consumer stream compatibility WITHOUT building
    a converter — the static-analysis query (analysis/itensor_check.py).

    Returns one of:
      * ``"match"``        — types equivalent; a raw FIFO fuses them.
      * ``"converter"``    — a bounded ping-pong window re-orders the
        stream (some loop prefix is shared, so at least one data dim
        buffers at element granularity).
      * ``"rebuffer"``     — no shared prefix covers any data dim: the
        converter degenerates to a full-tensor buffer, i.e. the "fusion"
        silently materializes the whole intermediate.
      * ``"incompatible"`` — different data space or dtype; no converter
        exists (``infer_converter`` would raise).
    """
    if src.dtype != res.dtype or src.data_shape != res.data_shape:
        return "incompatible"
    if src.canonicalize() == res.canonicalize():
        return "match"
    m = shared_prefix_length(src, res)
    results = src.iter_map.results
    if all(results[j] >= m for j in range(src.rank)):
        return "rebuffer"      # every data dim buffered at full extent
    return "converter"


# --------------------------------------------------------------------- #
# Reference / verification machinery
# --------------------------------------------------------------------- #

def min_buffer_tiles_sim(src: ITensorType, res: ITensorType) -> int:
    """True minimal converter capacity in *tiles*, by stream simulation.

    Model: tiles arrive in producer order (one-shot; no re-fetch).  The
    converter may hold up to B tiles and must emit tiles in consumer order; a
    held tile may be emitted many times (consumer reuse) and can be evicted
    only after its final emission.  The minimum feasible B equals the peak
    number of simultaneously-live tiles under the eager emission policy.

    Requires equal element shapes (a converter never re-tiles tokens, only
    re-orders them; re-tiling layouts fall back to full-window buffering in
    Algorithm 1 and are excluded here).
    """
    if src.elem_shape != res.elem_shape:
        raise ValueError("simulation requires matching element shapes")
    arrivals: List[int] = []
    seen = set()
    for tid in src.stream_tile_ids():
        if tid not in seen:  # producer reuse re-sends, consumer needs 1 copy
            seen.add(tid)
            arrivals.append(tid)
    demand = list(res.stream_tile_ids())

    remaining: Dict[int, int] = {}
    for tid in demand:
        remaining[tid] = remaining.get(tid, 0) + 1

    live: set = set()
    frontier = 0
    peak = 0
    for tid in arrivals:
        live.add(tid)
        peak = max(peak, len(live))
        # Advance the consumer as far as possible.
        while frontier < len(demand) and demand[frontier] in live:
            t = demand[frontier]
            frontier += 1
            remaining[t] -= 1
            if remaining[t] == 0:
                live.discard(t)
    if frontier != len(demand):
        raise RuntimeError("conversion infeasible: consumer demands unseen tile")
    return peak


def convert_stream(src: ITensorType, res: ITensorType,
                   data: np.ndarray) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Functional reference of a materialized converter (paper Fig. 7(a)).

    Streams ``data`` tile-by-tile in ``src`` order through a window buffer of
    the Algorithm-1 shape and emits tiles in ``res`` order.  Returns
    ``(src_order_tiles, res_order_tiles)`` so tests can check that the emitted
    stream equals directly slicing ``data`` in consumer order.
    """
    if tuple(data.shape) != src.data_shape:
        raise ValueError(f"data shape {data.shape} != {src.data_shape}")

    def slice_at(off: Sequence[int], elem: Sequence[int]) -> np.ndarray:
        idx = tuple(slice(o, o + e) for o, e in zip(off, elem))
        return data[idx]

    produced = [slice_at(off, src.elem_shape) for off in src.stream_offsets()]
    emitted = [slice_at(off, res.elem_shape) for off in res.stream_offsets()]
    return produced, emitted
