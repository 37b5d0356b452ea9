"""Static stream verifier of the port (the reference's ``repro.analysis``).

itensor-typed analysis of a ``StreamPlan`` + config that checks fusion
legality, the Hopper kernels' blocks and shared memory (and, on the card,
the cases their CUDA builds run), sharding-claim coherence and the
serving path's paged-memory and in-place-write invariants, all without
launching a kernel or touching a device.
"""

from .diagnostics import (Diagnostic, PlanVerificationError, clean, errors,
                          warnings_)
from .effects import check_effects
from .itensor_check import check_itensors, stage_itensor, stage_itensors
from .kernel_lint import check_kernels, smem_estimate
from .sharding_check import check_sharding
from .verify import verify_or_raise, verify_plan

__all__ = [
    "Diagnostic", "PlanVerificationError", "clean", "errors", "warnings_",
    "check_effects", "check_itensors", "check_kernels", "check_sharding",
    "stage_itensor", "stage_itensors", "verify_or_raise", "verify_plan",
    "smem_estimate",
]
