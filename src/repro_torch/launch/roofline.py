"""Roofline terms on the H100 (``repro/launch/roofline.py``).

    compute term    = step FLOPs / (chips * the compute dtype's peak)
    memory term     = step bytes / (chips * HBM bandwidth)
    collective term = collective bytes / (chips * link bandwidth)

The step's FLOPs and bytes come from ``launch.op_analysis`` (the
counterpart of XLA's ``cost_analysis``), counted the same whatever
implements the step.  The peaks are the card's
(``core/platforms.py``'s ``H100`` and ``H100_FP32_FLOPS``, each with its
data-sheet source there): one home for them, which ``chip_smoke.py``'s
per-kernel bounds import too.  ``model_flops`` is 6·N·D for a training
step and 2·N·D for inference (N the active parameters).
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..configs.base import ModelConfig, ShapeConfig
from ..core.platforms import H100, H100_FP32_FLOPS

HBM_BYTES_PER_S = H100.hbm_bw             # HBM3, bytes/s
LINK_BYTES_PER_S = H100.link_bw           # one NVLink 4 link, bytes/s
PEAK_FLOPS = {"bfloat16": H100.peak_flops,     # dense tensor-core bf16
              "float32": H100_FP32_FLOPS}      # float32 on the CUDA cores
PEAK_INT8_OPS = H100.peak_int8_ops        # dense int8 tensor cores


def bound(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """(milliseconds, "bytes" or "operations"): the least time the card
    takes to move ``nbytes`` through HBM and do ``flops`` at the peak of
    ``dtype``, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D for train, 2*N*D per generated/prefilled token otherwise."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def roofline_from_counts(cfg: ModelConfig, shape: ShapeConfig, rec: Dict, *,
                         chips: int = 1) -> Dict[str, float]:
    """The roofline of a dry-run record: ``rec["cost"]`` (per-chip
    ``flops``, ``bytes_accessed``) and ``rec["collectives"]["total"]``,
    at ``cfg.dtype``'s peak.  The terms are only as good as the counts:
    ``op_analysis``'s bytes are the eager plan's, so under them
    ``memory_s`` and ``step_s_lower_bound`` are the eager plan's, not a
    bound on a kernel plan's step (``compute_s`` holds for either)."""
    flops = rec["cost"]["flops"]
    bytes_accessed = rec["cost"]["bytes_accessed"]
    coll = rec["collectives"]["total"]
    peak = PEAK_FLOPS[cfg.dtype]
    compute_s = flops / peak
    memory_s = bytes_accessed / HBM_BYTES_PER_S
    collective_s = coll / LINK_BYTES_PER_S
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bound_by = max(terms, key=terms.get).replace("_s", "")
    mf = model_flops(cfg, shape)
    total_flops = flops * chips
    slowest = max(terms.values())
    return {
        **terms,
        "bound": bound_by,
        "step_s_lower_bound": slowest,
        "model_flops": mf,
        "hlo_flops_per_chip": flops,
        "useful_flops_ratio": mf / total_flops if total_flops else 0.0,
        "mfu_upper_bound": (mf / (chips * peak) / slowest
                            if slowest > 0 else 0.0),
    }
