"""Event bus: typed span/instant records for the serving runtime.

Port of ``repro.obs.events``, kept as its own copy (the port imports
nothing of the reference package); the event names, tracks and arguments
are the reference's, so the exports of the two read the same.

StreamTensor's argument is that performance lives in *where time and
bytes go*; this module makes the runtime schedule itself an inspectable
artifact.  Every interesting moment in the serving engine — a request
moving through its lifecycle, a dispatch occupying a slot, a page
changing hands, the tuner measuring a candidate — is recorded as a typed
``Event`` on a named *track*, and the exporters (``obs/export.py``) turn
the event list into a Perfetto-loadable Chrome trace, a JSONL log, or
feed the registry's Prometheus exposition.

Design constraints, in order:

  1. **Zero hot-path cost when disabled.**  ``NULL_RECORDER`` is a
     singleton whose ``instant``/``complete`` are no-ops and whose
     ``span`` returns one shared no-op context manager — no ``Event``
     (or any other) allocation ever happens, which the disabled-overhead
     test asserts through the event-count probe.  Emission sites on the
     engine's per-dispatch path additionally guard with
     ``recorder.enabled`` so even argument tuples are never built.
  2. **Deterministic under test.**  The clock is injectable: a
     ``ManualClock`` (optionally auto-ticking) makes span starts,
     durations, and orderings reproducible, so the export golden tests
     compare byte-exact output.
  3. **One timebase.**  The engine stamps ``Request`` lifecycle times
     with the SAME clock the recorder uses, so lifecycle instants and
     dispatch spans line up on the trace.

Event taxonomy (the names below are the vocabulary; DESIGN.md §17 has
the full table):

  * request lifecycle — ``req.queued`` → ``req.admitted`` →
    ``req.prefill_chunk`` (per chunk) → ``req.first_token`` →
    ``req.finished`` / ``req.rejected``
  * dispatch spans — ``dispatch.prefill`` / ``dispatch.prefill_chunk``
    / ``dispatch.decode`` / ``dispatch.verify`` on the engine track,
    mirrored per participating slot as ``prefill`` / ``prefill_chunk``
    / ``decode`` / ``verify`` on ``slot<i>`` tracks
  * compile probes — ``trace.prefill`` / ``trace.decode`` /
    ``trace.verify``: the reference emits them from inside its traced
    Python bodies, so their count equals its retrace counters; the
    port's engine builds no per-shape programs and emits none (its
    probe counters stay 0)
  * paged memory — ``page.alloc`` / ``page.free`` / ``page.cow`` /
    ``page.rollback`` / ``page.evict``
  * prefix cache — ``prefix.claim`` / ``prefix.insert`` /
    ``prefix.evict``
  * tuner — ``tune.measure`` / ``tune.prune``
  * scheduler — ``sched.budget`` / ``sched.admit_wave``
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

Clock = Callable[[], float]

# ----------------------------------------------------------------- names
# Request lifecycle (tracks: "sched" while queued, "slot<i>" once bound).
REQ_QUEUED = "req.queued"
REQ_ADMITTED = "req.admitted"
REQ_PREFILL_CHUNK = "req.prefill_chunk"
REQ_FIRST_TOKEN = "req.first_token"
REQ_FINISHED = "req.finished"
REQ_REJECTED = "req.rejected"

# Dispatch spans (engine track + per-slot mirrors).
DISPATCH_PREFILL = "dispatch.prefill"
DISPATCH_PREFILL_CHUNK = "dispatch.prefill_chunk"
DISPATCH_DECODE = "dispatch.decode"
DISPATCH_VERIFY = "dispatch.verify"

# Compile probes: emitted while jit TRACES the dispatch body, so the
# event count equals the engine's programs-built counters.
TRACE_PREFILL = "trace.prefill"
TRACE_DECODE = "trace.decode"
TRACE_VERIFY = "trace.verify"

# Paged-memory events (track "kv").
PAGE_ALLOC = "page.alloc"
PAGE_FREE = "page.free"
PAGE_COW = "page.cow"
PAGE_ROLLBACK = "page.rollback"
PAGE_EVICT = "page.evict"

# Prefix-cache events (track "prefix").
PREFIX_CLAIM = "prefix.claim"
PREFIX_INSERT = "prefix.insert"
PREFIX_EVICT = "prefix.evict"

# Tuner events (track "tune").
TUNE_MEASURE = "tune.measure"
TUNE_PRUNE = "tune.prune"

# Scheduler decisions (track "sched").
SCHED_BUDGET = "sched.budget"

# Canonical track names (slots add "slot0", "slot1", ...).
TRACK_ENGINE = "engine"
TRACK_SCHED = "sched"
TRACK_KV = "kv"
TRACK_PREFIX = "prefix"
TRACK_TUNE = "tune"


def slot_track(slot: int) -> str:
    return f"slot{slot}"


# ---------------------------------------------------------------- events
@dataclass(frozen=True)
class Event:
    """One record on the bus.

    ``kind`` is ``"span"`` (has a duration) or ``"instant"``.  ``ts`` /
    ``dur`` are SECONDS on the recorder's clock (exporters convert to
    trace-viewer microseconds).  ``track`` names the horizontal lane the
    event belongs to (one Perfetto thread per track); ``args`` carries
    the typed payload (slot, rid, page ids, ...)."""

    name: str
    kind: str                   # "span" | "instant"
    ts: float
    dur: float = 0.0
    track: str = TRACK_ENGINE
    args: Dict[str, Any] = field(default_factory=dict)

    @property
    def end(self) -> float:
        return self.ts + self.dur


# ---------------------------------------------------------------- clocks
class ManualClock:
    """Injectable deterministic clock for tests and golden exports.

    Every call advances the time by ``tick`` and returns the NEW value
    (so consecutive stamps are distinct, spans get nonzero durations
    without any explicit ``advance``, and — because engine request
    stamps use 0.0 as the "unset" sentinel — the default ``start=0.0``
    never leaks a zero stamp).  ``advance`` moves the clock by an
    arbitrary delta for scripted scenarios."""

    def __init__(self, start: float = 0.0, tick: float = 1e-6):
        self.t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        self.t += self.tick
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


# ------------------------------------------------------------- recorders
class _SpanCtx:
    """Re-entrant-free lightweight span context: stamps on enter, emits
    one span ``Event`` on exit.  Created per ``Recorder.span`` call."""

    __slots__ = ("_rec", "_name", "_track", "_args", "_t0")

    def __init__(self, rec: "Recorder", name: str, track: str,
                 args: Dict[str, Any]):
        self._rec = rec
        self._name = name
        self._track = track
        self._args = args
        self._t0 = 0.0

    def __enter__(self) -> "_SpanCtx":
        self._t0 = self._rec.clock()
        return self

    def __exit__(self, *exc) -> None:
        rec = self._rec
        rec._emit(Event(self._name, "span", self._t0,
                        rec.clock() - self._t0, self._track, self._args))


class Recorder:
    """Append-only event recorder with an injectable clock.

    ``max_events`` bounds memory on long-lived engines: past the cap new
    events are counted in ``dropped`` instead of stored (the metrics
    registry keeps aggregating regardless — only the timeline truncates).
    """

    enabled = True

    def __init__(self, clock: Optional[Clock] = None, *,
                 max_events: int = 1_000_000):
        self.clock: Clock = clock if clock is not None else time.perf_counter
        self.events: List[Event] = []
        self.max_events = max_events
        self.dropped = 0

    def _emit(self, ev: Event) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def now(self) -> float:
        return self.clock()

    def instant(self, name: str, *, track: str = TRACK_ENGINE,
                ts: Optional[float] = None, **args: Any) -> None:
        self._emit(Event(name, "instant",
                         self.clock() if ts is None else ts,
                         0.0, track, args))

    def complete(self, name: str, t0: float, dur: float, *,
                 track: str = TRACK_ENGINE, **args: Any) -> None:
        """Record an already-measured span (the engine times its own
        dispatches with the shared clock and reports start + duration —
        this also lets one measurement fan out to several tracks)."""
        self._emit(Event(name, "span", t0, dur, track, args))

    def span(self, name: str, *, track: str = TRACK_ENGINE,
             **args: Any) -> _SpanCtx:
        return _SpanCtx(self, name, track, args)

    def count(self, name: str) -> int:
        """Event-count probe: how many events carry ``name``."""
        return sum(1 for e in self.events if e.name == name)

    def clear(self) -> None:
        self.events.clear()
        self.dropped = 0


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """Disabled recorder: every method is a no-op and ``span`` returns
    one shared context object, so the hot path allocates NOTHING.  The
    ``events`` attribute is a shared empty tuple — the event-count probe
    reads zero, and appending is impossible by construction."""

    enabled = False
    events = ()
    dropped = 0
    clock: Clock = staticmethod(time.perf_counter)

    def now(self) -> float:
        return 0.0

    def instant(self, name: str, **kw: Any) -> None:
        return None

    def complete(self, name: str, t0: float, dur: float, **kw: Any) -> None:
        return None

    def span(self, name: str, **kw: Any) -> _NullSpan:
        return _NULL_SPAN

    def count(self, name: str) -> int:
        return 0

    def clear(self) -> None:
        return None


NULL_RECORDER = NullRecorder()


def resolve_recorder(spec, *, clock: Optional[Clock] = None):
    """Engine-facing resolution for ``ServingEngine(telemetry=...)``:

      * ``None`` / ``False`` -> ``NULL_RECORDER`` (zero-overhead)
      * ``True``             -> fresh ``Recorder`` (on ``clock`` when
                                given, so lifecycle stamps and spans
                                share a timebase)
      * ``Recorder``         -> used as given; an explicit ``clock``
                                rebinds it so the engine and recorder
                                can never disagree on the timebase
    """
    if spec is None or spec is False:
        return NULL_RECORDER
    if spec is True:
        return Recorder(clock)
    if isinstance(spec, (Recorder, NullRecorder)):
        if clock is not None and isinstance(spec, Recorder):
            spec.clock = clock
        return spec
    raise TypeError(f"telemetry= accepts bool or Recorder; "
                    f"got {type(spec).__name__}")
