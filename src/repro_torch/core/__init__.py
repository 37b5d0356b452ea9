"""Compiler-side records of the port (the StreamPlan)."""

from .stream_plan import (EAGER, STAGES, KernelChoice, LayerPlan, StreamPlan,
                          plan_for)

__all__ = ["EAGER", "STAGES", "KernelChoice", "LayerPlan", "StreamPlan",
           "plan_for"]
