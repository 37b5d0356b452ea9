"""Runtime layer of the port: the dataflow simulator."""

from .simulator import SimResult, simulate_dataflow

__all__ = ["SimResult", "simulate_dataflow"]
