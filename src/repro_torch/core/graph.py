"""Dataflow graph IR — kernels connected by itensor-typed streams.

This is the Python twin of the paper's MLIR dataflow dialect (§3.2): nodes are
``kernel`` ops (each containing one logical task), edges carry the producer's
output itensor type and the consumer's expected input itensor type, and all
dataflow components (converters, DMAs, FIFOs) are derived from those types.

Graph storage uses ``networkx.MultiDiGraph`` so that two distinct operands
between the same kernel pair stay distinct edges — Algorithm 2 indexes
``G.edges[p, n, 0]`` for exactly this reason.

A copy of the reference's ``repro.core.graph``, with the same names
and results.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import networkx as nx

from .converter import ConverterSpec, conversion_cost_bytes, infer_converter
from .itensor import ITensorType


@dataclass(frozen=True)
class KernelTiming:
    """Profiled/modelled kernel metrics (paper §5.3.1).

    All quantities are in cycles of the target platform clock.

    Attributes:
        initial_delay: ``D`` — cycles from kernel start to its first output
            token.
        pipeline_ii: ``II`` — cycles between consecutive output tokens.
        latency: ``L`` — total execution latency.  Defaults to the pipelined
            form ``D + (T-1) * II`` when constructed via ``from_tokens``.
    """

    initial_delay: float
    pipeline_ii: float
    latency: float

    @staticmethod
    def from_tokens(initial_delay: float, pipeline_ii: float,
                    num_tokens: int) -> "KernelTiming":
        return KernelTiming(
            initial_delay=initial_delay,
            pipeline_ii=pipeline_ii,
            latency=initial_delay + max(0, num_tokens - 1) * pipeline_ii,
        )

    def with_ii(self, ii: float, num_tokens: int) -> "KernelTiming":
        return KernelTiming.from_tokens(self.initial_delay, ii, num_tokens)


@dataclass
class KernelNode:
    """A dataflow kernel (paper Fig. 1 'Kernel').

    Attributes:
        name: unique id.
        op: operator kind ("matmul", "elementwise", "softmax", ...).
        out_type: itensor type of the (single) output stream.
        in_types: itensor types expected on each input port.
        timing: (L, D, II) model; filled by the platform model.
        work_flops: arithmetic work, for the latency model / roofline.
        weight_bytes: resident parameter bytes streamed from external memory.
        local_bytes: on-chip buffer footprint of the kernel itself
            (accumulators, line buffers), excluding converters/FIFOs.
        tags: free-form annotations (e.g. source linalg op, tiling record).
    """

    name: str
    op: str
    out_type: ITensorType
    in_types: Tuple[ITensorType, ...] = ()
    timing: Optional[KernelTiming] = None
    work_flops: float = 0.0
    weight_bytes: float = 0.0
    local_bytes: float = 0.0
    tags: Dict[str, object] = field(default_factory=dict)

    @property
    def num_out_tokens(self) -> int:
        return self.out_type.num_tokens


class DataflowGraph:
    """Kernel graph with itensor-typed edges."""

    def __init__(self) -> None:
        self.g = nx.MultiDiGraph()

    # ------------------------------------------------------------- build
    def add_kernel(self, node: KernelNode) -> KernelNode:
        if node.name in self.g:
            raise ValueError(f"duplicate kernel {node.name}")
        self.g.add_node(node.name, kernel=node)
        return node

    def connect(self, producer: str, consumer: str, *,
                src_type: Optional[ITensorType] = None,
                dst_type: Optional[ITensorType] = None,
                operand: int = 0) -> None:
        """Add a stream edge; types default to the endpoints' port types."""
        p, c = self.kernel(producer), self.kernel(consumer)
        s = src_type or p.out_type
        d = dst_type
        if d is None:
            d = c.in_types[operand] if operand < len(c.in_types) else s
        if s.data_shape != d.data_shape:
            raise ValueError(
                f"edge {producer}->{consumer}: data space {s.data_shape} vs "
                f"{d.data_shape}")
        self.g.add_edge(producer, consumer, src_type=s, dst_type=d,
                        operand=operand)

    # ------------------------------------------------------------ access
    def kernel(self, name: str) -> KernelNode:
        return self.g.nodes[name]["kernel"]

    def kernels(self) -> Iterator[KernelNode]:
        for n in self.g.nodes:
            yield self.kernel(n)

    def topo_order(self) -> List[str]:
        return list(nx.topological_sort(self.g))

    def edges(self) -> Iterator[Tuple[str, str, int, dict]]:
        yield from self.g.edges(keys=True, data=True)

    def predecessors(self, name: str) -> List[str]:
        return list(self.g.predecessors(name))

    def successors(self, name: str) -> List[str]:
        return list(self.g.successors(name))

    @property
    def num_kernels(self) -> int:
        return self.g.number_of_nodes()

    # -------------------------------------------------------- analyses
    def edge_converter(self, u: str, v: str, key: int = 0) -> Optional[ConverterSpec]:
        data = self.g.edges[u, v, key]
        return infer_converter(data["src_type"], data["dst_type"])

    def edge_memory_cost(self, u: str, v: str, key: int = 0) -> float:
        """On-chip bytes to stream-fuse across this edge.

        converter ping-pong bytes (0 on matching types) + a minimal
        depth-2 FIFO of one token (re-sized later by fifo_sizing).
        """
        data = self.g.edges[u, v, key]
        conv = conversion_cost_bytes(data["src_type"], data["dst_type"])
        fifo = 2.0 * data["src_type"].token_bytes
        return conv + fifo

    def intermediate_bytes_unfused(self) -> float:
        """External-memory intermediate footprint with *no* fusion.

        Every internal edge materializes its full tensor in memory — the
        baseline of the paper's Fig. 10a memory-reduction study.
        """
        total = 0.0
        for u, v, k, data in self.edges():
            total += data["src_type"].data_bytes
        return total

    def intermediate_bytes_fused(self, fusion_index: Dict[str, int]) -> float:
        """On-chip streaming footprint after fusion: converters + min FIFOs
        for intra-group edges; inter-group edges still hit external memory and
        are excluded (they are counted by the caller as DMA traffic)."""
        total = 0.0
        for u, v, k, data in self.edges():
            if fusion_index.get(u) == fusion_index.get(v):
                total += self.edge_memory_cost(u, v, k)
        return total

    def total_work_flops(self) -> float:
        return sum(k.work_flops for k in self.kernels())

    def total_weight_bytes(self) -> float:
        return sum(k.weight_bytes for k in self.kernels())

    def validate(self) -> None:
        if not nx.is_directed_acyclic_graph(self.g):
            raise ValueError("dataflow graph must be a DAG")
        for u, v, k, data in self.edges():
            s, d = data["src_type"], data["dst_type"]
            if s.dtype != d.dtype:
                raise ValueError(f"edge {u}->{v}: dtype {s.dtype} vs {d.dtype}")

    def __repr__(self) -> str:
        return (f"DataflowGraph({self.g.number_of_nodes()} kernels, "
                f"{self.g.number_of_edges()} streams)")
