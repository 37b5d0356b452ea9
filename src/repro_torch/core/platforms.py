"""Hardware platform models.

A copy of the reference's ``repro.core.platforms``.  ``U55C``, ``A100``,
``RTX2080TI`` and ``TPU_V5E`` are the reference compiler's target
descriptions, verbatim: the paper's Table 6 platforms and the reference's
TPU v5e constants (197 TFLOP/s bf16, 819 GB/s HBM, 128 MiB VMEM, ~50
GB/s/link ICI).  They are inputs of the analytic compiler, kept so that
``compile_model`` here decides what the reference decides; none of them
describes the Hopper card the port's kernels run on.  ``H100`` does: it is
the port's target (``build_stream_plan``'s default), with the card's
constants and their sources beside them.

The platform object is the single source of truth for:
  * roofline terms (compute / memory / collective seconds),
  * the fusion budget ``C_max`` (paper §5.2.2: total on-chip memory), and
  * the (L, D, II) timing model of dataflow kernels (paper §5.3.1), which on
    FPGA comes from HLS profiling and here from an analytic
    work/bandwidth/parallelism model calibrated to the platform.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .graph import KernelNode, KernelTiming


@dataclass(frozen=True)
class Platform:
    """A dataflow / accelerator platform model.

    Attributes:
        name: display name.
        freq_hz: clock frequency used by the cycle-level token model.
        peak_flops: peak arithmetic throughput (FLOP/s) in the native
            compute precision.
        peak_int8_ops: peak INT8 OPS (paper Table 6 row) when different.
        hbm_bw: external memory bandwidth, bytes/s.
        link_bw: per-link interconnect bandwidth, bytes/s (ICI on TPU,
            inter-FPGA on the paper platform; 0 = single device only).
        onchip_bytes: total fast on-chip memory (BRAM+URAM / VMEM).
        smem_bytes: small scratch tier (LUTRAM / SMEM).
        dma_ports: independent external-memory ports (HBM pseudo-channels /
            DMA engines); bounds how many kernels can stream from DRAM at once.
        compute_lanes: parallel MAC lanes available to one kernel at unroll 1
            -- the unit the tiling space's unroll factors multiply.
        thermal_power_w: design power for the energy model (paper Fig. 9).
    """

    name: str
    freq_hz: float
    peak_flops: float
    hbm_bw: float
    link_bw: float
    onchip_bytes: float
    smem_bytes: float = 0.0
    peak_int8_ops: float = 0.0
    dma_ports: int = 32
    compute_lanes: int = 512
    thermal_power_w: float = 0.0

    # ------------------------------------------------------------ roofline
    def compute_seconds(self, flops: float, chips: int = 1) -> float:
        return flops / (chips * self.peak_flops)

    def memory_seconds(self, bytes_moved: float, chips: int = 1) -> float:
        return bytes_moved / (chips * self.hbm_bw)

    def collective_seconds(self, coll_bytes: float, chips: int = 1) -> float:
        if self.link_bw <= 0:
            return 0.0
        return coll_bytes / (chips * self.link_bw)

    def roofline_seconds(self, flops: float, bytes_moved: float,
                         coll_bytes: float = 0.0, chips: int = 1) -> float:
        """max of the three terms — the roofline lower bound on step time."""
        return max(self.compute_seconds(flops, chips),
                   self.memory_seconds(bytes_moved, chips),
                   self.collective_seconds(coll_bytes, chips))

    # ------------------------------------------------------- token model
    def kernel_timing(self, node: KernelNode, unroll: int = 1) -> KernelTiming:
        """Model (L, D, II) of a dataflow kernel (paper §5.3.1).

        On the paper's flow these numbers come from vendor-HLS profiling; we
        model them from first principles so the same LP/fusion machinery runs
        offline:

          * ``II``  — cycles between output tokens: the larger of the compute
            bound (token FLOPs / (lanes * unroll * 2 flop/MAC/cycle)) and the
            DRAM bound for weight-streaming kernels.
          * ``D``   — initial delay: one full input token must arrive plus the
            kernel's own pipeline fill (modeled as one II plus a fixed
            pipeline depth).
          * ``L``   — ``D + (T-1) * II``.
        """
        tokens = max(1, node.num_out_tokens)
        flops_per_token = node.work_flops / tokens
        # MACs per cycle one kernel can retire at this unroll.
        macs_per_cycle = max(1.0, float(self.compute_lanes * unroll))
        compute_cycles = flops_per_token / (2.0 * macs_per_cycle)
        # Weight-streaming bound: bytes of parameters read per token.
        bw_per_port = self.hbm_bw / max(1, self.dma_ports)
        weight_bytes_per_token = node.weight_bytes / tokens
        mem_cycles = weight_bytes_per_token / (bw_per_port / self.freq_hz)
        ii = max(1.0, compute_cycles, mem_cycles)
        pipeline_depth = 32.0  # fixed stage fill, HLS-typical
        d = ii + pipeline_depth
        return KernelTiming.from_tokens(d, ii, tokens)

    def seconds(self, cycles: float) -> float:
        return cycles / self.freq_hz

    # --------------------------------------------------------------- misc
    def fusion_budget(self, fraction: float = 1.0) -> float:
        """C_max for Algorithm 2 — paper uses total on-chip memory."""
        return self.onchip_bytes * fraction


# --------------------------------------------------------------------- #
# Platform instances (paper Table 6 + the brief's TPU v5e constants)
# --------------------------------------------------------------------- #

U55C = Platform(
    name="AMD-U55C",
    freq_hz=250e6,
    peak_flops=24.5e12 / 2,   # 24.5 INT8 TOPS; ~half in W4A8 MACs w/ packing
    peak_int8_ops=24.5e12,
    hbm_bw=460e9,
    link_bw=0.0,
    onchip_bytes=41 * 2**20,
    smem_bytes=4 * 2**20,
    dma_ports=32,             # HBM2 pseudo-channels
    compute_lanes=1024,       # DSP-derived MAC lanes at 250 MHz
    thermal_power_w=150.0,
)

A100 = Platform(
    name="NVIDIA-A100",
    freq_hz=1.065e9,
    peak_flops=624e12 / 2,    # W8A8 via INT8 tensor cores (paper Table 6)
    peak_int8_ops=624e12,
    hbm_bw=1935e9,
    link_bw=600e9 / 12,
    onchip_bytes=40 * 2**20,
    thermal_power_w=300.0,
)

RTX2080TI = Platform(
    name="NVIDIA-2080Ti",
    freq_hz=1.35e9,
    peak_flops=215.2e12 / 2,
    peak_int8_ops=215.2e12,
    hbm_bw=616e9,
    link_bw=0.0,
    onchip_bytes=5.5 * 2**20,
    thermal_power_w=250.0,
)

TPU_V5E = Platform(
    name="TPU-v5e",
    freq_hz=940e6,
    peak_flops=197e12,        # bf16, from the brief
    peak_int8_ops=394e12,
    hbm_bw=819e9,             # from the brief
    link_bw=50e9,             # ~50 GB/s per ICI link, from the brief
    onchip_bytes=128 * 2**20,  # VMEM
    smem_bytes=1 * 2**20,
    dma_ports=16,
    compute_lanes=128 * 128,  # one MXU systolic array
    thermal_power_w=200.0,
)

# The card the port's kernels run on: NVIDIA H100 SXM5 80 GB (sm_90a).
_H100_SMS = 132                 # streaming multiprocessors
_H100_TC_MACS = 4 * 512         # bf16 MACs per cycle per SM: 4 tensor
                                # cores x 512 dense (989e12 / 2 / 132 SMs
                                # at the 1830 MHz the rate is quoted at)
H100 = Platform(
    name="NVIDIA-H100",
    freq_hz=1.98e9,           # nvidia-smi --query-gpu=clocks.max.sm: 1980 MHz
    peak_flops=989e12,        # dense bf16 tensor cores, H100 SXM5 data sheet
    peak_int8_ops=1979e12,    # dense int8 tensor cores, same sheet
    hbm_bw=3.35e12,           # HBM3, same sheet
    link_bw=50e9,             # one NVLink 4 link (900 GB/s over 18, each
                              # way); unused on one card
    onchip_bytes=50 * 2**20,  # L2, the whole chip's on-chip tier (as
                              # A100 counts its 40 MiB L2)
    smem_bytes=232_448,       # shared memory one block may opt into
    dma_ports=_H100_SMS,      # every SM streams from HBM on its own
                              # (cp.async / TMA per SM)
    compute_lanes=_H100_TC_MACS,  # one block runs on one SM: the unit an
                                  # unroll factor multiplies
    thermal_power_w=700.0,    # SXM5 board power limit
)

# float32 outside the tensor cores (the CUDA cores' FMA rate), H100 SXM5
# data sheet: the port's float32 kernels stay off the tensor cores.
H100_FP32_FLOPS = 67e12

PLATFORMS: Dict[str, Platform] = {
    "u55c": U55C, "a100": A100, "2080ti": RTX2080TI, "tpu_v5e": TPU_V5E,
    "h100": H100,
}


def get_platform(name: str) -> Platform:
    try:
        return PLATFORMS[name.lower()]
    except KeyError:
        raise KeyError(f"unknown platform {name!r}; have {sorted(PLATFORMS)}")
