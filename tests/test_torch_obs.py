"""The port's telemetry modules (``repro_torch.obs``) against the
reference's (``repro.obs``) on the CPU.

Each scenario of the reference's ``tests/test_obs.py`` runs through both
packages and the results must be equal: ``log_buckets``, histogram edges,
percentiles and windows, non-finite observations, counter / gauge / info
semantics, kind-mismatch errors, ``MetricsView``, ``ManualClock``, span
nesting and ``max_events``, the ``NullRecorder``'s inertness,
``resolve_recorder`` and ``validate_chrome_trace``'s problem lists.  The
port's three exports of the reference test's golden scenario equal
``tests/data/obs/trace.json``, ``events.jsonl`` and ``metrics.prom`` byte
for byte (read only, never regenerated).

The modules are pure Python: results compare exactly (``nan`` as a
string, so that it equals itself).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import repro.obs as JO
import repro_torch.obs as TO

DATA = os.path.join(os.path.dirname(__file__), "data", "obs")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (restored after the module), so that test
    workers beside one another do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _norm(x):
    """Results with ``nan`` made comparable and tuples made lists."""
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _same(scenario):
    """``scenario(module)`` through both packages; equal results."""
    want = _norm(scenario(JO))
    got = _norm(scenario(TO))
    assert got == want
    return got


def test_all_names_equal_the_reference():
    assert TO.__all__ == JO.__all__
    # The whole event-name and track vocabulary, TRACE_* and TUNE_* too.
    vocab = {n: v for n, v in vars(JO.events).items()
             if n.isupper() and isinstance(v, str)}
    assert len(vocab) == 29
    assert {n: getattr(TO.events, n, None) for n in vocab} == vocab
    assert {n for n in dir(JO) if n.isupper()} == {
        n for n in dir(TO) if n.isupper()}
    assert TO.slot_track(3) == JO.slot_track(3) == "slot3"


@pytest.mark.parametrize("lo,hi,per_decade", [
    (1e-3, 10.0, 4), (1e-5, 100.0, 4), (1e-3, 1.0, 1), (0.5, 7.0, 3),
    (1e-6, 1e-2, 10)])
def test_log_buckets(lo, hi, per_decade):
    b = _same(lambda m: m.log_buckets(lo, hi, per_decade))
    assert b[0] == pytest.approx(lo) and b[-1] >= hi


@pytest.mark.parametrize("bad", [(0, 1, 4), (1, 1, 4), (1e-3, 10, 0)])
def test_log_buckets_refuse_bad_specs(bad):
    def scenario(m):
        with pytest.raises(ValueError) as e:
            m.log_buckets(*bad)
        return str(e.value)
    _same(scenario)


def test_histogram_edges_and_default_bounds():
    def scenario(m):
        h = m.Histogram("lat", lo=1e-3, hi=1.0, per_decade=1, unit="s")
        h.observe(1e-2)                     # on a bound: that bucket
        h.observe(1e-2 * 1.0001)            # just above: the next
        h.observe(5.0)                      # the overflow bucket
        d = m.Histogram("d")
        return {"bounds": h.bounds, "counts": h.counts(),
                "count": h.count(), "sum": h.sum(), "mean": h.mean(),
                "default_bounds": d.bounds, "unit": d.unit}
    out = _same(scenario)
    assert out["counts"] == [0, 1, 1, 0, 1]
    assert len(out["default_bounds"]) == 29       # 1e-5..100 s, 4 a decade


def test_histogram_skips_non_finite():
    def scenario(m):
        h = m.Histogram("lat")
        for v in (float("nan"), float("inf"), -float("inf"), 0.5):
            h.observe(v)
        e = m.Histogram("empty")
        return {"count": h.count(), "sum": h.sum(), "counts": h.counts(),
                "empty": [e.percentile(q) for q in (0.5, 0.9, 0.99)],
                "empty_mean": e.mean()}
    assert _same(scenario)["count"] == 1


@pytest.mark.parametrize("seed", [7, 11])
def test_histogram_percentiles(seed):
    vals = np.exp(np.random.default_rng(seed).normal(-2.0, 2.0, size=500))

    def scenario(m):
        h = m.Histogram("lat", lo=1e-5, hi=100.0, per_decade=4)
        for v in vals:
            h.observe(float(v))
        with pytest.raises(ValueError) as e:
            h.percentile(0.0)
        return {"p": [h.percentile(q) for q in (0.01, 0.5, 0.9, 0.99, 1.0)],
                "err": str(e.value)}
    p = _same(scenario)["p"]
    assert p == sorted(p) and vals.min() <= p[0] and p[-1] <= vals.max()


def test_histogram_window_views():
    def scenario(m):
        h = m.Histogram("lat", lo=1e-3, hi=1.0, per_decade=2)
        h.observe(0.001)
        h.observe(0.002)
        h.mark()
        h.observe(0.9)
        return {v: [h.count(v), h.sum(v), h.counts(v), h.mean(v),
                    [h.percentile(q, v) for q in (0.5, 0.9, 0.99)]]
                for v in ("lifetime", "last_generate")}
    out = _same(scenario)
    assert out["lifetime"][0] == 3 and out["last_generate"][0] == 1


def test_counter_gauge_info_semantics():
    def scenario(m):
        c = m.Counter("n", "help")
        c.inc()
        c.inc(4)
        c.mark()
        c.inc(2)
        with pytest.raises(ValueError) as e:
            c.inc(-1)
        g = m.Gauge("peak")
        g.set(5)
        g.max(3)
        first = g.value()
        g.max(9)
        g.mark()
        i = m.Info("quant", value="none")
        i.mark()
        i.set("w8")
        return {"counter": [c.value("lifetime"), c.value("last_generate")],
                "err": str(e.value), "gauge": [first, g.value(),
                                               g.value("last_generate")],
                "info": [i.value(), i.value("last_generate")],
                "kinds": [c.kind, g.kind, i.kind]}
    out = _same(scenario)
    assert out["counter"] == [7, 2] and out["gauge"] == [5, 9, 9]


def test_registry_kind_mismatch_views_and_metrics_view():
    def scenario(m):
        reg = m.Registry()
        reg.counter("generated", "tokens out")
        reg.histogram("ttft_s", "time to first token")
        errs = []
        for declare in (reg.gauge, reg.info, reg.histogram):
            with pytest.raises(TypeError) as e:
                declare("generated")
            errs.append(str(e.value))
        same = reg.counter("generated") is reg["generated"]
        reg["generated"].inc(3)
        reg["ttft_s"].observe(0.25)
        reg.info("quant", value="none")
        reg.gauge("pages", value=2)
        view = m.MetricsView(reg)
        missing = []
        for key in ("nope", "ttft_s", "ttft_s_p75", "quant_count"):
            with pytest.raises(KeyError):
                view[key]
            missing.append(key)
        with pytest.raises(TypeError):
            view["generated"] = 1           # read-only: writes go typed
        snap_w = reg.snapshot("last_generate")
        reg.mark()
        with pytest.raises(ValueError) as bad_view:
            reg.snapshot("bogus")
        with pytest.raises(ValueError):
            m.MetricsView(reg, "bogus")
        return {"errs": errs, "same": same, "view": dict(view),
                "keys": list(view), "len": len(view),
                "contains": ["generated" in reg, "nope" in reg],
                "snap_w": snap_w, "after_mark": reg.snapshot("last_generate"),
                "lifetime": reg.snapshot("lifetime"),
                "bad_view": str(bad_view.value), "missing": missing,
                "repr": repr(view)}
    out = _same(scenario)
    assert out["view"]["generated"] == 3 and out["view"]["ttft_s_count"] == 1
    assert out["after_mark"]["generated"] == 0


def test_manual_clock():
    def scenario(m):
        clk = m.ManualClock()
        a = clk()
        t1, t2 = clk(), clk()
        adv = clk.advance(1.0)
        fast = m.ManualClock(start=5.0, tick=0.25)
        return [a, t1, t2, adv, clk(), fast(), fast()]
    out = _same(scenario)
    assert out[0] > 0.0 and out[1] < out[2] < out[3]


def test_recorder_span_nesting_complete_and_max_events():
    def scenario(m):
        rec = m.Recorder(m.ManualClock(tick=1.0))
        with rec.span("outer", track="engine", a=1):
            rec.instant("mid", track="engine")
            with rec.span("inner", track="slot0"):
                pass
        rec.complete("d", 1.0, 0.5, track="kv", n=3)
        rec.instant("at", ts=0.25, x="y")
        evs = [(e.name, e.kind, e.ts, e.dur, e.track, e.args, e.end)
               for e in rec.events]
        counts = [rec.count(n) for n in ("inner", "nope", "mid")]
        capped = m.Recorder(m.ManualClock(tick=1.0), max_events=2)
        for name in "abc":
            capped.instant(name)
        dropped = (len(capped.events), capped.dropped)
        capped.clear()
        return {"events": evs, "counts": counts, "dropped": dropped,
                "cleared": (list(capped.events), capped.dropped),
                "now": rec.now(), "enabled": rec.enabled}
    out = _same(scenario)
    assert [e[0] for e in out["events"][:3]] == ["mid", "inner", "outer"]
    assert out["dropped"] == [2, 1]


def test_null_recorder_is_inert():
    def scenario(m):
        nr = m.NULL_RECORDER
        nr.instant("x", track="engine", a=1)
        nr.complete("y", 0.0, 1.0)
        with nr.span("a"):
            pass
        nr.clear()
        return {"enabled": nr.enabled, "events": nr.events,
                "count": nr.count("x"), "now": nr.now(),
                "dropped": nr.dropped,
                "shared_span": nr.span("a") is nr.span("b"),
                "tuple": isinstance(nr.events, tuple),
                "fresh_shares": m.NullRecorder().span("c") is nr.span("d")}
    out = _same(scenario)
    assert out["shared_span"] and out["events"] == [] and not out["enabled"]


def test_resolve_recorder():
    def scenario(m):
        clk = m.ManualClock()
        rec = m.resolve_recorder(True, clock=clk)
        mine = m.Recorder()
        with pytest.raises(TypeError) as e:
            m.resolve_recorder("yes")
        null = m.NullRecorder()
        return {"none": m.resolve_recorder(None) is m.NULL_RECORDER,
                "false": m.resolve_recorder(False) is m.NULL_RECORDER,
                "true": isinstance(rec, m.Recorder) and rec.clock is clk,
                "given": m.resolve_recorder(mine) is mine,
                "rebound": m.resolve_recorder(mine, clock=clk).clock is clk,
                "null": m.resolve_recorder(null, clock=clk) is null,
                "err": str(e.value)}
    out = _same(scenario)
    assert all(v is True for k, v in out.items() if k != "err")


# --------------------------------------------------------------- goldens

def _golden_events(m):
    """The reference test's fixed mini-lifecycle (``test_obs.py``)."""
    rec = m.Recorder(m.ManualClock(tick=0.001))
    rec.instant(m.REQ_QUEUED, track="engine", rid=0, prompt_len=12)
    rec.instant(m.REQ_ADMITTED, track=m.slot_track(0), rid=0)
    rec.complete("prefill", 0.002, 0.010, track=m.slot_track(0), rid=0,
                 tokens=12)
    rec.instant(m.REQ_FIRST_TOKEN, track=m.slot_track(0), rid=0,
                ttft_s=0.011)
    rec.complete("decode", 0.012, 0.004, track="engine", block=4,
                 slots=1)
    rec.instant("page.alloc", track="kv", page=3, free=5)
    rec.instant(m.REQ_FINISHED, track=m.slot_track(0), rid=0, tokens=4,
                failed=False)
    return rec.events


def _golden_registry(m):
    reg = m.Registry()
    reg.counter("generated", "tokens generated").inc(4)
    reg.counter("dispatches", "decode dispatches").inc(1)
    reg.gauge("pages_in_use", "allocated KV pages").set(3)
    h = reg.histogram("ttft_s", "time to first token",
                      lo=1e-3, hi=10.0, per_decade=2)
    for v in (0.011, 0.02, 0.5):
        h.observe(v)
    reg.info("quant", "KV quantization mode", value="none")
    reg.info("plan_source", "plan provenance", value="analytic")
    return reg


def _read(name):
    with open(os.path.join(DATA, name)) as fh:
        return fh.read()


def test_chrome_trace_golden():
    trace = TO.chrome_trace(_golden_events(TO))
    assert TO.validate_chrome_trace(trace) == []
    assert json.dumps(trace, indent=1) + "\n" == _read("trace.json")


def test_events_jsonl_golden():
    assert TO.events_jsonl(_golden_events(TO)) == _read("events.jsonl")
    assert TO.events_jsonl([]) == JO.events_jsonl([]) == ""


def test_prometheus_golden():
    assert TO.prometheus_text(_golden_registry(TO)) == _read("metrics.prom")


@pytest.mark.parametrize("view", ["lifetime", "last_generate"])
def test_prometheus_views_and_namespace_equal_the_reference(view):
    def scenario(m):
        reg = _golden_registry(m)
        reg.mark()
        reg["generated"].inc(2)
        reg["ttft_s"].observe(3.0)
        reg["ttft_s"].observe(50.0)             # the overflow bucket
        reg.gauge("odd.name-x", value=float("nan"))
        reg.gauge("big", value=1e16)
        reg.gauge("neg_inf", value=-float("inf"))
        reg.info("path", value='a"b\\c\nd')
        reg.histogram("bytes", unit="B").observe(2.5)
        return [m.prometheus_text(reg, view=view),
                m.prometheus_text(reg, namespace="x", view=view)]
    _same(scenario)


def test_chrome_trace_lanes_equal_the_reference():
    def scenario(m):
        rec = m.Recorder(m.ManualClock(tick=0.5))
        for track in ("slot10", "sched", "slot2", "engine", "kv", "slot0"):
            rec.instant("x", track=track)
        rec.complete("d", 1e-7, 2.5e-7, track="prefix", k=1)
        return m.chrome_trace(rec.events)
    out = _same(scenario)
    meta = [e["args"]["name"] for e in out["traceEvents"] if e["ph"] == "M"]
    assert meta == ["sched", "engine", "kv", "prefix", "slot0", "slot2",
                    "slot10"]


BAD_TRACES = (
    {},
    {"traceEvents": []},
    {"traceEvents": [{"ph": "Z", "pid": 1, "tid": 1},
                     {"ph": "X", "pid": 1, "tid": 9, "name": "d",
                      "ts": -1.0}]},
    {"traceEvents": ["x", {"ph": "i", "pid": "1", "tid": 1.5},
                     {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name"},
                     {"ph": "X", "pid": 1, "tid": 1, "name": "",
                      "ts": 0, "dur": -2},
                     {"ph": "X", "pid": 1, "tid": 1, "name": "ok",
                      "ts": "0", "dur": None}]},
)


@pytest.mark.parametrize("i", range(len(BAD_TRACES)))
def test_validate_chrome_trace_problem_lists(i):
    errs = _same(lambda m: m.validate_chrome_trace(BAD_TRACES[i]))
    assert errs
