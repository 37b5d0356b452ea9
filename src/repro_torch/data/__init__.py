"""Deterministic sharded data pipeline (copy of ``repro.data``)."""
from .pipeline import EOS, IGNORE, PipelineState, TokenPipeline
__all__ = ["EOS", "IGNORE", "PipelineState", "TokenPipeline"]
