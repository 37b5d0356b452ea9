"""StreamTensor core of the port: the itensor type system, Algorithm 1,
fusion, FIFO sizing, the tiling DSE, partition, allocation and lowering
(copies of the reference's ``repro.core``), the ``H100`` platform the
port targets, and ``build_stream_plan`` / ``plan_for``, which turn the
compiler's decisions into the plan the model runs."""

from .affine import AffineMap
from .allocation import AllocationResult, Buffer, MemoryTier, allocate
from .dma import DmaPlan, dma_seconds, plan_dma
from .dse import DSEResult, TrialResult, evaluate_trial, explore
from .lowering import CompiledDataflow, compile_model, lower_groups
from .partition import PartitionResult, partition
from .platforms import (H100, PLATFORMS, TPU_V5E, U55C, Platform,
                        get_platform)
from .tiling import (LinalgOpSpec, LoopDim, OperandSpec, TiledKernel,
                     TilingDecision, TilingSpace, tile_op)
from .trace import block_flops, trace_block, trace_lm_head
from .converter import (ConverterSpec, conversion_cost_bytes, infer_converter,
                        min_buffer_tiles_sim, shared_prefix_length)
from .fifo_sizing import FifoPlan, size_fifos, solve_start_times
from .fusion import FusionPlan, explore_fusion, fusion_memory_report
from .graph import DataflowGraph, KernelNode, KernelTiming
from .itensor import (ITensorType, col_major, fig5_b, fig5_c,
                      itensor_from_tiling, row_major)
from .stream_plan import (EAGER, STAGES, KernelChoice, LayerPlan, StreamPlan,
                          build_stream_plan, plan_for)
from .token_model import (EqualizationStrategy, max_tokens_exact,
                          max_tokens_paper, simulate_fifo_occupancy)

__all__ = [
    "AffineMap", "ITensorType", "itensor_from_tiling", "row_major", "col_major",
    "fig5_b", "fig5_c", "ConverterSpec", "infer_converter",
    "conversion_cost_bytes", "min_buffer_tiles_sim", "shared_prefix_length",
    "DataflowGraph", "KernelNode", "KernelTiming", "FusionPlan",
    "explore_fusion", "fusion_memory_report", "FifoPlan", "size_fifos",
    "solve_start_times", "EqualizationStrategy", "max_tokens_exact",
    "max_tokens_paper", "simulate_fifo_occupancy",
    "AllocationResult", "Buffer", "MemoryTier", "allocate",
    "DmaPlan", "dma_seconds", "plan_dma",
    "DSEResult", "TrialResult", "evaluate_trial", "explore",
    "CompiledDataflow", "compile_model", "lower_groups",
    "PartitionResult", "partition",
    "H100", "PLATFORMS", "TPU_V5E", "U55C", "Platform", "get_platform",
    "LinalgOpSpec", "LoopDim", "OperandSpec", "TiledKernel",
    "TilingDecision", "TilingSpace", "tile_op",
    "block_flops", "trace_block", "trace_lm_head",
    "EAGER", "STAGES", "KernelChoice", "LayerPlan", "StreamPlan",
    "build_stream_plan", "plan_for",
]
