"""On-chip memory tier allocation — paper §5.3(3).

The paper places each buffer in LUTRAM, BRAM, or URAM "prioritized by size".
We reproduce that policy generically over a platform's tier table.  A copy
of the reference's ``repro.core.allocation``: ``TPU_TIERS`` is the
reference's TPU hierarchy (SMEM / VMEM / HBM-spill), kept verbatim so that
``compile_model`` places buffers as the reference does for its four
platforms.  ``H100_TIERS`` is the Hopper card's hierarchy (a block's shared
memory, the L2, HBM), over which ``compile_model`` allocates for ``H100``.
Inputs are the buffers the
rest of the compiler produced: converter ping-pong windows (Alg. 1), FIFO
backing stores (LP sizing), DMA staging buffers, and kernel accumulators.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class MemoryTier:
    name: str
    capacity_bytes: float
    word_bytes: int = 8          # allocation granularity
    max_buffer_bytes: Optional[float] = None   # per-buffer cap (LUTRAM-like)


# Paper platform (U55C): LUTRAM ~ distributed RAM, BRAM 36Kb blocks, URAM 288Kb.
U55C_TIERS = (
    MemoryTier("LUTRAM", 2 * 2**20, word_bytes=8, max_buffer_bytes=4096),
    MemoryTier("BRAM", 9 * 2**20, word_bytes=4608),
    MemoryTier("URAM", 30 * 2**20, word_bytes=36864),
)

# TPU target: SMEM (scalar scratch), VMEM (vector memory), HBM spill.
TPU_TIERS = (
    MemoryTier("SMEM", 1 * 2**20, word_bytes=4, max_buffer_bytes=16384),
    MemoryTier("VMEM", 128 * 2**20, word_bytes=4096),
    MemoryTier("HBM", 16 * 2**30, word_bytes=4096),
)

# H100 SXM5: the shared memory one block may opt into (the kernels' tiles
# and rings, 16-byte copies), the 50 MiB L2 (128-byte lines), 80 GB of HBM.
H100_TIERS = (
    MemoryTier("SMEM", 232_448, word_bytes=16, max_buffer_bytes=232_448),
    MemoryTier("L2", 50 * 2**20, word_bytes=128),
    MemoryTier("HBM", 80 * 2**30, word_bytes=4096),
)


@dataclass
class Buffer:
    name: str
    bytes: float
    kind: str = "buffer"     # converter | fifo | staging | accumulator


@dataclass
class AllocationResult:
    placement: Dict[str, str]            # buffer -> tier name
    tier_used: Dict[str, float]
    spilled: List[str]                   # buffers that fell to the last tier

    def utilization(self, tiers: Sequence[MemoryTier]) -> Dict[str, float]:
        caps = {t.name: t.capacity_bytes for t in tiers}
        return {n: self.tier_used.get(n, 0.0) / caps[n] for n in caps}


def allocate(buffers: Sequence[Buffer],
             tiers: Sequence[MemoryTier] = TPU_TIERS) -> AllocationResult:
    """Paper policy: sort by size, place each buffer in the smallest tier that
    (a) admits its size per-buffer cap and (b) still has capacity; rounded up
    to the tier's allocation word."""
    used: Dict[str, float] = {t.name: 0.0 for t in tiers}
    placement: Dict[str, str] = {}
    spilled: List[str] = []
    for buf in sorted(buffers, key=lambda b: b.bytes):
        placed = False
        for tier in tiers:
            size = math.ceil(buf.bytes / tier.word_bytes) * tier.word_bytes
            if tier.max_buffer_bytes and buf.bytes > tier.max_buffer_bytes:
                continue
            if used[tier.name] + size <= tier.capacity_bytes:
                used[tier.name] += size
                placement[buf.name] = tier.name
                placed = True
                break
        if not placed:
            last = tiers[-1]
            size = math.ceil(buf.bytes / last.word_bytes) * last.word_bytes
            used[last.name] += size
            placement[buf.name] = last.name
            spilled.append(buf.name)
    if spilled and tiers[-1].name != "HBM":
        pass  # FPGA: overflow is a fusion-feedback signal, surfaced by caller
    return AllocationResult(placement=placement, tier_used=used,
                            spilled=spilled)


def buffers_from_plan(graph, fusion, fifo) -> List[Buffer]:
    """Collect every on-chip buffer the compiler produced for allocation."""
    out: List[Buffer] = []
    for k in graph.kernels():
        if k.local_bytes:
            out.append(Buffer(f"acc:{k.name}", k.local_bytes, "accumulator"))
    for u, v, key, data in graph.edges():
        if fusion.index.get(u) != fusion.index.get(v):
            continue
        conv = graph.edge_converter(u, v, key)
        if conv is not None:
            out.append(Buffer(f"conv:{u}->{v}#{key}", conv.pingpong_bytes,
                              "converter"))
        out.append(Buffer(f"fifo:{u}->{v}#{key}",
                          fifo.fifo_bytes[(u, v, key)], "fifo"))
    return out
