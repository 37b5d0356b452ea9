"""Measured-latency autotuner (DESIGN.md §16), the port of ``repro.tuning``.

Three parts: a measurement harness (``measure``) that times lint-legal
candidates of the Hopper kernels with CUDA events on the card (the
analytic surrogate on the CPU); a persistent, versioned,
backend-fingerprinted latency table (``table``) with build-once/reuse
semantics and atomic writes; and the plumbed objective (``autotune``)
that rewrites a StreamPlan's block/page/chunk choices from the scores and
stamps every ``KernelChoice`` with its cost provenance.  Entry points:
``ServingEngine(autotune=...)``, ``build_stream_plan(tune=...)``,
``python -m repro_torch.analysis.verify --tuned`` and the ``python -m
repro_torch.tuning`` round-trip check.
"""

from .autotune import (Tuner, TunerStats, active_tuner, card_blocks,
                       default_table_path, enumerate_candidates,
                       resolve_tuner, use_tuner)
from .measure import analytic_estimate, measure, measure_candidate
from .table import (SCHEMA_VERSION, TuneEntry, TuneTable,
                    backend_fingerprint, make_key)

__all__ = [
    "SCHEMA_VERSION", "TuneEntry", "TuneTable", "Tuner", "TunerStats",
    "active_tuner", "analytic_estimate", "backend_fingerprint",
    "card_blocks", "default_table_path", "enumerate_candidates",
    "make_key", "measure", "measure_candidate", "resolve_tuner",
    "use_tuner",
]
