"""Observability for the serving runtime: events, metrics, exporters.

Port of ``repro.obs``, with the same names and ``__all__``.  Usage from
the engine side::

    from repro_torch.obs import Recorder, ManualClock
    eng = ServingEngine(..., telemetry=True)          # fresh Recorder
    eng = ServingEngine(..., telemetry=Recorder(),
                        clock=ManualClock(tick=1e-4))
    eng.generate(prompts)
    trace = chrome_trace(eng.obs.events)              # Perfetto-loadable
    text = prometheus_text(eng.registry)              # exposition
    win = eng.snapshot("last_generate")               # windowed metrics

``python -m repro_torch.obs --demo`` bursts a small engine and writes all
three artifacts; DESIGN.md §17 documents the taxonomy and formats.
"""

from .events import (
    Clock,
    Event,
    ManualClock,
    NULL_RECORDER,
    NullRecorder,
    Recorder,
    resolve_recorder,
    slot_track,
)
from .events import (  # noqa: F401  (event-name vocabulary)
    DISPATCH_DECODE,
    DISPATCH_PREFILL,
    DISPATCH_PREFILL_CHUNK,
    DISPATCH_VERIFY,
    PAGE_ALLOC,
    PAGE_COW,
    PAGE_EVICT,
    PAGE_FREE,
    PAGE_ROLLBACK,
    PREFIX_CLAIM,
    PREFIX_EVICT,
    PREFIX_INSERT,
    REQ_ADMITTED,
    REQ_FINISHED,
    REQ_FIRST_TOKEN,
    REQ_PREFILL_CHUNK,
    REQ_QUEUED,
    REQ_REJECTED,
    SCHED_BUDGET,
    TRACE_DECODE,
    TRACE_PREFILL,
    TRACE_VERIFY,
    TRACK_ENGINE,
    TRACK_KV,
    TRACK_PREFIX,
    TRACK_SCHED,
    TRACK_TUNE,
    TUNE_MEASURE,
    TUNE_PRUNE,
)
from .export import (
    chrome_trace,
    events_jsonl,
    prometheus_text,
    validate_chrome_trace,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    Info,
    MetricsView,
    Registry,
    log_buckets,
)

__all__ = [
    "Clock", "Event", "ManualClock", "NullRecorder", "NULL_RECORDER",
    "Recorder", "resolve_recorder", "slot_track",
    "Counter", "Gauge", "Histogram", "Info", "MetricsView", "Registry",
    "log_buckets",
    "chrome_trace", "events_jsonl", "prometheus_text",
    "validate_chrome_trace",
]
