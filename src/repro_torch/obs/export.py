"""Exporters: Chrome trace-event JSON, JSONL event log, Prometheus text.

Port of ``repro.obs.export``, kept as its own copy: the output is byte for
byte the reference's (``tests/data/obs/`` holds the goldens), including
the ``repro_`` exposition prefix, which is the system's metric namespace.

Three read-only views over the same two data sources (the recorder's
event list and the metrics registry):

  * ``chrome_trace(events)`` — Chrome trace-event JSON, loadable in
    Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.  One
    pid for the engine process, one tid per *track* (``engine``,
    ``sched``, ``kv``, ``prefix``, ``tune``, ``slot0..N``), with
    ``thread_name`` metadata so the UI labels lanes.  Spans become
    ``ph:"X"`` complete events, instants become ``ph:"i"`` with
    thread scope; timestamps are microseconds as the format requires.
  * ``events_jsonl(events)`` — one JSON object per line, stable key
    order, for ad-hoc ``jq``/pandas analysis.
  * ``prometheus_text(registry)`` — Prometheus text exposition 0.0.4.
    Counters/gauges map 1:1; histograms emit the standard cumulative
    ``_bucket{le="..."}`` / ``_sum`` / ``_count`` series PLUS
    ``_p50``/``_p90``/``_p99`` gauges (precomputed quantiles must be
    their own families — mixing them into the histogram type is
    invalid exposition).  Info metrics fold into one
    ``<ns>_build_info``-style sample with the values as labels.

All output is deterministic given deterministic inputs (sorted label
sets, insertion-ordered tracks/metrics, fixed float formatting) so the
golden-file tests compare byte-exact.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List

from .events import Event
from .metrics import Counter, Gauge, Histogram, Info, Registry, _PCTS

PID = 1  # single engine process; tracks map to tids


def _track_tids(events: Iterable[Event]) -> Dict[str, int]:
    """Assign tids by first appearance, slots sorted after named tracks
    so the Perfetto lane order is stable regardless of admission order."""
    seen: List[str] = []
    for ev in events:
        if ev.track not in seen:
            seen.append(ev.track)
    named = [t for t in seen if not t.startswith("slot")]
    slots = sorted((t for t in seen if t.startswith("slot")),
                   key=lambda t: int(t[4:]))
    return {t: i + 1 for i, t in enumerate(named + slots)}


def _us(t: float) -> float:
    return round(t * 1e6, 3)


def chrome_trace(events: Iterable[Event]) -> Dict[str, Any]:
    """Build the Chrome trace-event JSON object (dump with
    ``json.dump``; Perfetto loads the file as-is)."""
    events = list(events)
    tids = _track_tids(events)
    trace: List[Dict[str, Any]] = []
    for track, tid in tids.items():
        trace.append({"ph": "M", "pid": PID, "tid": tid,
                      "name": "thread_name", "args": {"name": track}})
    for ev in events:
        rec: Dict[str, Any] = {
            "name": ev.name, "pid": PID, "tid": tids[ev.track],
            "ts": _us(ev.ts), "cat": ev.name.split(".", 1)[0],
        }
        if ev.kind == "span":
            rec["ph"] = "X"
            rec["dur"] = _us(ev.dur)
        else:
            rec["ph"] = "i"
            rec["s"] = "t"  # thread-scoped instant
        if ev.args:
            rec["args"] = dict(ev.args)
        trace.append(rec)
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def events_jsonl(events: Iterable[Event]) -> str:
    """One compact JSON object per event, one per line."""
    lines = []
    for ev in events:
        lines.append(json.dumps(
            {"name": ev.name, "kind": ev.kind, "ts": ev.ts,
             "dur": ev.dur, "track": ev.track, "args": dict(ev.args)},
            separators=(",", ":"), sort_keys=False))
    return "\n".join(lines) + ("\n" if lines else "")


# ------------------------------------------------------------- prometheus
def _sanitize(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if v != v:                       # nan
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_escape(v: Any) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def prometheus_text(registry: Registry, *, namespace: str = "repro",
                    view: str = "lifetime") -> str:
    """Prometheus text exposition of the registry's ``view``."""
    out: List[str] = []
    infos: List[Info] = []
    for m in registry.metrics():
        full = f"{namespace}_{_sanitize(m.name)}"
        if isinstance(m, Info):
            infos.append(m)
            continue
        if isinstance(m, Counter):
            name = full + "_total"
            out.append(f"# HELP {name} {m.help or m.name}")
            out.append(f"# TYPE {name} counter")
            out.append(f"{name} {_fmt(m.value(view))}")
        elif isinstance(m, Gauge):
            out.append(f"# HELP {full} {m.help or m.name}")
            out.append(f"# TYPE {full} gauge")
            out.append(f"{full} {_fmt(m.value(view))}")
        elif isinstance(m, Histogram):
            if m.unit and not full.endswith("_" + m.unit):
                full = f"{full}_{m.unit}"
            out.append(f"# HELP {full} {m.help or m.name}")
            out.append(f"# TYPE {full} histogram")
            counts = m.counts(view)
            cum = 0
            for bound, c in zip(m.bounds, counts):
                cum += c
                out.append(f'{full}_bucket{{le="{_fmt(bound)}"}} {cum}')
            cum += counts[-1]
            out.append(f'{full}_bucket{{le="+Inf"}} {cum}')
            out.append(f"{full}_sum {_fmt(m.sum(view))}")
            out.append(f"{full}_count {m.count(view)}")
            for tag, q in _PCTS:
                qn = f"{full}_{tag}"
                out.append(f"# HELP {qn} {q:g} quantile of {m.name}")
                out.append(f"# TYPE {qn} gauge")
                out.append(f"{qn} {_fmt(m.percentile(q, view))}")
    if infos:
        name = f"{namespace}_info"
        labels = ",".join(
            f'{_sanitize(i.name)}="{_label_escape(i.value())}"'
            for i in infos)
        out.append(f"# HELP {name} engine configuration / provenance")
        out.append(f"# TYPE {name} gauge")
        out.append(f"{name}{{{labels}}} 1")
    return "\n".join(out) + "\n"


def validate_chrome_trace(trace: Dict[str, Any]) -> List[str]:
    """Self-contained schema check (no jsonschema dependency): returns a
    list of problems, empty when the object is a loadable trace."""
    errs: List[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return ["traceEvents missing or empty"]
    tids_named = set()
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            errs.append(f"[{i}] not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            errs.append(f"[{i}] bad ph {ph!r}")
            continue
        if not isinstance(e.get("pid"), int) or not isinstance(
                e.get("tid"), int):
            errs.append(f"[{i}] pid/tid not int")
        if ph == "M":
            if e.get("name") == "thread_name":
                tids_named.add((e.get("pid"), e.get("tid")))
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            errs.append(f"[{i}] missing name")
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"[{i}] bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"[{i}] bad dur {dur!r}")
        if (e.get("pid"), e.get("tid")) not in tids_named:
            errs.append(f"[{i}] tid {e.get('tid')} has no thread_name")
    return errs
