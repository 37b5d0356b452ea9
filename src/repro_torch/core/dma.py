"""DMA materialization: pack / widen planning — paper §4.2, §4.3.1.

At every fused-kernel boundary, tensors living in external memory are moved by
DMAs whose behavior is fully determined by the boundary itensor type
(paper Fig. 7(a)-(b)): load order, staging ping-pong buffer, and stream push
layout.  To maximize external bandwidth, StreamTensor

  * **packs** the tensor into a tiled layout so each tile is contiguous
    (a ``[64,64]`` tensor tiled ``[16,16]`` becomes ``[4,4,16,16]``), making
    every DMA burst long; and
  * **widens** elements into vectors matching the memory bus (512-bit DDR/HBM
    with uint8 -> ``vector<64>``).

Pack/widen fold into static tensors (pre-trained parameters) at zero runtime
cost; for activations they cancel against the unpack/unwiden of the adjacent
layer when the tiling space aligns layouts (paper §4.2).  The TPU analogue is
choosing parameter layouts tile-contiguous at load time and keeping the last
dim a multiple of the 128-lane register width.

A copy of the reference's ``repro.core.dma``, with the same names
and results.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from .itensor import ITensorType, dtype_bytes


@dataclass(frozen=True)
class DmaPlan:
    """Materialized DMA for one kernel-boundary tensor (paper Fig. 7(b)).

    Attributes:
        tensor_shape: logical tensor shape.
        packed_shape: tiled storage layout (grid dims + tile dims + vector).
        vector_width: elements fused into one bus word ("widen").
        burst_elems: contiguous elements per DMA burst after packing.
        staging_bytes: on-chip ping-pong staging buffer (2x one token).
        bursts: number of bursts per pass.
        efficiency: fraction of peak bus bandwidth achieved (long bursts
            amortize row-activation overhead; model: burst/(burst+setup)).
        is_static: parameter tensor -> pack folds offline, no runtime cost.
    """

    tensor_shape: Tuple[int, ...]
    packed_shape: Tuple[int, ...]
    vector_width: int
    burst_elems: int
    staging_bytes: float
    bursts: int
    efficiency: float
    is_static: bool

    @property
    def total_bytes(self) -> float:
        return math.prod(self.tensor_shape) * self._elem_bytes

    @property
    def _elem_bytes(self) -> float:
        # packed_shape carries no dtype; staging/total use the planner's.
        return self.__dict__.get("_eb", 1.0)


def plan_dma(itype: ITensorType, *, bus_bits: int = 512,
             burst_setup_elems: int = 16,
             is_static: bool = False) -> DmaPlan:
    """Derive the pack/widen plan from a boundary itensor type.

    Pack: storage order = grid-major over the *stream* order's data walk, tile
    elements contiguous.  Widen: group ``bus_bits / elem_bits`` elements.
    """
    eb = dtype_bytes(itype.dtype)
    vector_width = max(1, int(bus_bits // (eb * 8)))
    tile_elems = math.prod(itype.elem_shape)
    # Widen cannot exceed one tile; clip to a divisor of the tile.
    while vector_width > 1 and tile_elems % vector_width != 0:
        vector_width //= 2
    grid = itype.grid_shape
    packed = tuple(grid) + tuple(itype.elem_shape)
    burst = tile_elems  # a packed tile is fully contiguous
    eff = burst / (burst + burst_setup_elems)
    plan = DmaPlan(
        tensor_shape=itype.data_shape,
        packed_shape=packed,
        vector_width=vector_width,
        burst_elems=burst,
        staging_bytes=2.0 * itype.token_bytes,
        bursts=int(math.prod(grid)) * itype.reuse_factor,
        efficiency=eff,
        is_static=is_static,
    )
    object.__setattr__(plan, "_eb", eb)
    return plan


def unpacked_efficiency(itype: ITensorType,
                        burst_setup_elems: int = 16) -> float:
    """Bandwidth efficiency *without* packing: bursts break at tile rows.

    Row-major storage means one tile reads ``elem_shape[:-1]`` separate rows
    of ``elem_shape[-1]`` contiguous elements each.
    """
    row = itype.elem_shape[-1] if itype.elem_shape else 1
    return row / (row + burst_setup_elems)


def dma_seconds(plan: DmaPlan, hbm_bw: float) -> float:
    """Transfer time accounting for burst efficiency (0 for folded statics —
    parameters are charged once by the caller, not per pass)."""
    return plan.total_bytes / (hbm_bw * plan.efficiency)


def pack_fold_report(plans: Sequence[DmaPlan]) -> dict:
    """How much pack/widen runtime cost folds away (paper §4.2: only model
    inputs/outputs pay; statics fold into the parameter files)."""
    total = sum(p.total_bytes for p in plans)
    folded = sum(p.total_bytes for p in plans if p.is_static)
    return {"total_bytes": total, "folded_bytes": folded,
            "runtime_bytes": total - folded,
            "folded_fraction": folded / total if total else 0.0}
