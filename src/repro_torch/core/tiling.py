"""Linalg tiling space — paper §5.1.

The tiling space decides, for every dataflow kernel: tile sizes, loop
permutation, unroll factors, and input/output vectorization.  Its input is a
graph of *Linalg-like op specs* — einsum-style structured ops with named
iteration dims (parallel or reduction) and per-operand dim maps — produced by
``trace.py`` from a model block.  Its output is a tiled kernel whose operand
**itensor types** are derived mechanically (paper §4.1):

  * the tiled loop nest's tripcounts/steps define the iteration space,
  * each operand's dim map defines the affine iteration map (loops that do not
    index the operand become *reuse* dims — the Fig. 5(c) pattern appears for
    free on e.g. matmul inputs),
  * tile extents define the element shape.

Paper heuristics reproduced:
  * ``default_tile_size`` applied across all dims (clipped to the largest
    divisor of the extent; exact tilings only).
  * Intensity-aware unrolling: a max-heap repeatedly selects the kernel with
    the longest modeled latency and doubles its unroll factor until the global
    ``overall_unroll_size`` budget is exhausted.
  * Permutation: reduction loops outermost *inside* the pipelined tile body
    (II -> 1: no loop-carried dependence in the inner parallel loops), while
    the inter-tile nest keeps reduction tiles innermost so outputs stream as
    soon as their reduction completes.
  * Vectorization factors inferred from the unroll factor on the innermost
    parallel data dim (itensor ``vectorize``).

A copy of the reference's ``repro.core.tiling``, with the same names
and results.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from .affine import AffineMap
from .graph import DataflowGraph, KernelNode, KernelTiming
from .itensor import ITensorType, dtype_bytes
from .platforms import Platform

PARALLEL = "parallel"
REDUCTION = "reduction"


@dataclass(frozen=True)
class LoopDim:
    """One named iteration dimension of a structured op."""
    name: str
    extent: int
    kind: str = PARALLEL

    def __post_init__(self) -> None:
        if self.kind not in (PARALLEL, REDUCTION):
            raise ValueError(f"bad loop kind {self.kind}")
        if self.extent <= 0:
            raise ValueError(f"bad extent {self.extent}")


@dataclass(frozen=True)
class OperandSpec:
    """A tensor operand: which iteration dims index each data dim.

    ``tensor_id`` names the logical tensor; producer/consumer ops that share a
    ``tensor_id`` get a stream edge in the dataflow graph.
    """
    tensor_id: str
    dims: Tuple[str, ...]
    dtype: str = "bfloat16"
    is_weight: bool = False   # resident parameter, streamed from DRAM


@dataclass(frozen=True)
class LinalgOpSpec:
    """Einsum-like structured op (the paper's tiled ``linalg.generic``)."""
    name: str
    op: str
    loops: Tuple[LoopDim, ...]
    inputs: Tuple[OperandSpec, ...]
    output: OperandSpec
    flops_per_point: float = 2.0   # FLOPs per iteration-space point

    def loop(self, name: str) -> LoopDim:
        for l in self.loops:
            if l.name == name:
                return l
        raise KeyError(f"{self.name}: no loop {name}")

    @property
    def loop_names(self) -> Tuple[str, ...]:
        return tuple(l.name for l in self.loops)

    @property
    def iter_points(self) -> int:
        return math.prod(l.extent for l in self.loops)

    @property
    def work_flops(self) -> float:
        return self.iter_points * self.flops_per_point

    def operand_shape(self, spec: OperandSpec) -> Tuple[int, ...]:
        return tuple(self.loop(d).extent for d in spec.dims)

    def validate(self) -> None:
        names = self.loop_names
        if len(set(names)) != len(names):
            raise ValueError(f"{self.name}: duplicate loop names")
        for spec in (*self.inputs, self.output):
            for d in spec.dims:
                self.loop(d)
        for d in spec.dims:
            if self.loop(d).kind == REDUCTION and d in self.output.dims:
                raise ValueError(f"{self.name}: reduction dim {d} in output")


# --------------------------------------------------------------------- #
# Tiling decisions
# --------------------------------------------------------------------- #

@dataclass
class TilingDecision:
    """Per-kernel configuration chosen by the tiling space."""
    tile_sizes: Dict[str, int]          # loop name -> tile extent
    loop_order: Tuple[str, ...]         # inter-tile loop nest, outermost first
    unroll: int = 1
    vector_factor: int = 1
    reduction_outer_intra: bool = True  # paper's permutation heuristic


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= cap (>=1)."""
    cap = max(1, min(n, cap))
    for d in range(cap, 0, -1):
        if n % d == 0:
            return d
    return 1


def default_decision(op: LinalgOpSpec, default_tile_size: int) -> TilingDecision:
    """Paper §5.1: one global ``default_tile_size`` across all dims, then the
    permutation heuristic (parallel tiles outer / reduction tiles innermost at
    the inter-tile level so outputs stream eagerly)."""
    tiles = {l.name: largest_divisor_leq(l.extent, default_tile_size)
             for l in op.loops}
    par = [l.name for l in op.loops if l.kind == PARALLEL]
    red = [l.name for l in op.loops if l.kind == REDUCTION]
    return TilingDecision(tile_sizes=tiles, loop_order=tuple(par + red))


@dataclass
class TiledKernel:
    """A structured op after tiling: itensor types on every port."""
    spec: LinalgOpSpec
    decision: TilingDecision
    in_types: Tuple[ITensorType, ...]
    out_type: ITensorType
    local_accum_bytes: float            # on-chip accumulator footprint
    weight_bytes: float

    @property
    def name(self) -> str:
        return self.spec.name

    def to_kernel_node(self) -> KernelNode:
        return KernelNode(
            name=self.spec.name,
            op=self.spec.op,
            out_type=self.out_type,
            in_types=self.in_types,
            work_flops=self.spec.work_flops,
            weight_bytes=self.weight_bytes,
            local_bytes=self.local_accum_bytes,
            tags={"decision": self.decision,
                  "tensor_ids": tuple(i.tensor_id for i in self.spec.inputs),
                  "out_tensor_id": self.spec.output.tensor_id},
        )


def _operand_itensor(op: LinalgOpSpec, spec: OperandSpec,
                     dec: TilingDecision, *, is_output: bool) -> ITensorType:
    """Derive an itensor type for one operand of a tiled op (paper §4.1).

    The iteration space is the inter-tile loop nest (one loop per op loop dim
    in ``dec.loop_order``); loops not indexing the operand are reuse dims.
    For the *output*, reduction loops are excluded from the iteration space:
    the result tile is pushed once, after its reduction completes (the
    accumulator holds it on-chip until then).
    """
    order = [n for n in dec.loop_order]
    if is_output:
        order = [n for n in order if op.loop(n).kind != REDUCTION]
    tripcounts, steps = [], []
    pos: Dict[str, int] = {}
    for k, n in enumerate(order):
        l = op.loop(n)
        t = dec.tile_sizes[n]
        tripcounts.append(l.extent // t)
        steps.append(t)
        pos[n] = k
    results = tuple(pos[d] for d in spec.dims)
    elem = tuple(dec.tile_sizes[d] for d in spec.dims)
    # Canonicalize away tripcount-1 loops that feed no data dim.
    it = ITensorType(elem_shape=elem, tripcounts=tuple(tripcounts),
                     steps=tuple(steps),
                     iter_map=AffineMap(len(order), results),
                     dtype=spec.dtype)
    return it.canonicalize()


def tile_op(op: LinalgOpSpec, dec: TilingDecision) -> TiledKernel:
    """Apply a tiling decision; mechanical itensor-type derivation."""
    op.validate()
    for n, t in dec.tile_sizes.items():
        if op.loop(n).extent % t != 0:
            raise ValueError(f"{op.name}: tile {t} does not divide "
                             f"{op.loop(n).extent} ({n})")
    if sorted(dec.loop_order) != sorted(op.loop_names):
        raise ValueError(f"{op.name}: loop_order must permute {op.loop_names}")

    in_types = tuple(_operand_itensor(op, s, dec, is_output=False)
                     for s in op.inputs)
    out_type = _operand_itensor(op, op.output, dec, is_output=True)
    # Note: the decision's vector_factor widens *FIFO tokens* (paper §4.3.3);
    # it is applied symmetrically per edge in ``TilingSpace.build_graph`` so
    # producer/consumer types stay paired.

    # Accumulator: one output tile per in-flight reduction (ping-pong'd).
    acc_elems = math.prod(dec.tile_sizes[d] for d in op.output.dims)
    has_red = any(l.kind == REDUCTION for l in op.loops)
    local = (2.0 if has_red else 1.0) * acc_elems * dtype_bytes(op.output.dtype)
    weight_bytes = 0.0
    for s in op.inputs:
        if s.is_weight:
            weight_bytes += (math.prod(op.operand_shape(s))
                             * dtype_bytes(s.dtype))
    return TiledKernel(spec=op, decision=dec, in_types=in_types,
                       out_type=out_type, local_accum_bytes=local,
                       weight_bytes=weight_bytes)


# --------------------------------------------------------------------- #
# Graph-level tiling: build a DataflowGraph from op specs
# --------------------------------------------------------------------- #

@dataclass
class TilingSpace:
    """The tiling design space for a graph of structured ops (paper §5.1).

    Hyperparameters (explored by ``dse.py``):
        default_tile_size: global tile extent applied across all dims.
        overall_unroll_size: total unroll budget distributed by the
            intensity-aware algorithm.
    """
    ops: List[LinalgOpSpec]
    default_tile_size: int = 64
    overall_unroll_size: int = 64

    def decide(self, platform: Platform) -> Dict[str, TilingDecision]:
        decisions = {op.name: default_decision(op, self.default_tile_size)
                     for op in self.ops}
        self._intensity_aware_unroll(decisions, platform)
        for op in self.ops:
            d = decisions[op.name]
            d.vector_factor = self._infer_vector_factor(op, d)
        return decisions

    # -- paper §5.1: max-heap latency balancing ------------------------- #
    def _intensity_aware_unroll(self, decisions: Dict[str, TilingDecision],
                                platform: Platform) -> None:
        """Iteratively double the unroll of the longest-latency kernel until
        the total unroll budget ``overall_unroll_size`` is reached."""
        def latency(op: LinalgOpSpec, unroll: int) -> float:
            node = tile_op(op, decisions[op.name]).to_kernel_node()
            return platform.kernel_timing(node, unroll=unroll).latency

        heap: List[Tuple[float, str, LinalgOpSpec]] = []
        for op in self.ops:
            heapq.heappush(heap, (-latency(op, 1), op.name, op))
        budget = self.overall_unroll_size - len(self.ops)  # every kernel >= 1
        while heap and budget > 0:
            neg_lat, name, op = heapq.heappop(heap)
            d = decisions[name]
            if d.unroll * 2 - d.unroll > budget:
                break
            budget -= d.unroll          # doubling adds `unroll` more lanes
            d.unroll *= 2
            heapq.heappush(heap, (-latency(op, d.unroll), name, op))

    def _infer_vector_factor(self, op: LinalgOpSpec,
                             d: TilingDecision) -> int:
        """Vectorization inferred from unroll on the innermost parallel data
        dim (paper: 'vectorization factors are inferred by analyzing the loop
        iteration space and tensor shapes')."""
        if not op.output.dims:
            return 1
        inner = op.output.dims[-1]
        tile = d.tile_sizes[inner]
        grid = op.loop(inner).extent // tile
        f = 1
        while f * 2 <= d.unroll and grid % (f * 2) == 0:
            f *= 2
        return f

    # ------------------------------------------------------------------ #
    def build_graph(self, platform: Platform,
                    decisions: Optional[Dict[str, TilingDecision]] = None,
                    ) -> DataflowGraph:
        """Tile every op and wire producer->consumer edges by tensor id.

        This is the paper's Linalg-to-dataflow conversion (§4.1): each tiled
        loop nest becomes a ``kernel`` whose boundary types are itensors.
        """
        decisions = decisions or self.decide(platform)
        graph = DataflowGraph()
        producer_of: Dict[str, str] = {}
        tiled: Dict[str, TiledKernel] = {}
        for op in self.ops:
            tk = tile_op(op, decisions[op.name])
            tiled[op.name] = tk
            node = tk.to_kernel_node()
            node.timing = platform.kernel_timing(
                node, unroll=decisions[op.name].unroll)
            graph.add_kernel(node)
            if op.output.tensor_id in producer_of:
                raise ValueError(f"tensor {op.output.tensor_id} produced twice")
            producer_of[op.output.tensor_id] = op.name
        for op in self.ops:
            for i, spec in enumerate(op.inputs):
                p = producer_of.get(spec.tensor_id)
                if p is None:
                    continue   # graph input or weight: DMA at kernel boundary
                src = tiled[p].out_type
                dst = tiled[op.name].in_types[i]
                # Vectorize the FIFO token symmetrically (paper §4.3.3): both
                # ends widen by the common factor so the pairing stays typed.
                f = min(decisions[p].vector_factor,
                        decisions[op.name].vector_factor)
                src, dst = _widen_edge(src, dst, f)
                graph.connect(p, op.name, src_type=src, dst_type=dst,
                              operand=i)
        graph.validate()
        return graph


def _widen_edge(src: ITensorType, dst: ITensorType,
                factor: int) -> Tuple[ITensorType, ITensorType]:
    """Widen both end types of an edge by the same token vector factor."""
    while factor > 1:
        fs = [1] * src.rank
        fs[-1] = factor
        fd = [1] * dst.rank
        fd[-1] = factor
        try:
            return src.vectorize(fs), dst.vectorize(fd)
        except ValueError:
            factor //= 2
    return src, dst
