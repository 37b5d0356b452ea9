"""The port's engine with telemetry on, against
``repro.serving.ServingEngine(telemetry=True, verify="off")`` on the CPU.

The reference test's burst (``tests/test_obs.py``): reduced gpt2 in
float32 on the kernel plan, weights jittered
(``repro.serving.accuracy.jitter_params`` before ``np.asarray``), 2 slots,
``max_len`` 96, ``decode_block`` 4, chunked prefill in 16-token chunks and
speculative decode with 4 drafts, ``ManualClock(tick=1e-4)`` on both sides.

* greedy tokens equal the JAX engine's;
* the event ``(name, track)`` sequence equals the JAX engine's once its
  ``trace.*`` compile probes are removed (the port builds no per-shape
  programs), and so do the arguments of every event;
* every counter equals the JAX engine's (the trace probes: 0 against its
  programs built) and every histogram's ``_count`` its counterpart's;
* ``snapshot()`` has the reference's key set in both views, and so does
  ``metrics``, a read-only mapping;
* the lifecycle order and the shared-clock identities of
  ``test_obs.py``'s burst test hold;
* with telemetry off the tokens are the same and no event is recorded;
* ``python -m repro_torch.obs --demo --device cpu`` returns 0 and writes
  its three files.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.obs import ManualClock as JManualClock
from repro.serving import ServingEngine as JServingEngine
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.obs import (DISPATCH_PREFILL_CHUNK, DISPATCH_VERIFY,
                             NULL_RECORDER, REQ_ADMITTED, REQ_FINISHED,
                             REQ_FIRST_TOKEN, REQ_QUEUED, ManualClock,
                             chrome_trace, validate_chrome_trace)
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import COUNTER_NAMES

KW = dict(batch_slots=2, max_len=96, decode_block=4, chunked=True,
          prefill_chunk=16, speculative=True, draft_len=4)
NEW = 10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread (restored after the module), so that test
    workers beside one another do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs():
    kw = dict(dtype="float32", use_fused_kernels=True)
    return (dataclasses.replace(j_get_config("gpt2").reduced(), **kw),
            dataclasses.replace(get_config("gpt2").reduced(), **kw))


def _burst_prompts(vocab):
    """``test_obs.py``'s three prompts: two repetitive, one short."""
    return [
        np.array(([1, 2, 3, 4, 5, 6, 7, 8] * 4)[:30], np.int32) % vocab,
        np.array([9, 8, 7, 6, 5], np.int32) % vocab,
        np.array([1, 2, 3, 4] * 5, np.int32) % vocab,
    ]


@pytest.fixture(scope="module")
def runs():
    """The burst through the JAX engine and the port's, telemetry on
    (shared by every test), and the port's with telemetry off."""
    j_cfg, t_cfg = _configs()
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(0), j_cfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                           device="cpu")
    prompts = _burst_prompts(t_cfg.vocab_size)
    ref = JServingEngine(j_cfg, jp, verify="off", telemetry=True,
                         clock=JManualClock(tick=1e-4), **KW)
    want = ref.generate([p.copy() for p in prompts], max_new_tokens=NEW)
    # Both engines skip the plan verifier (``verified`` 0 on both sides);
    # test_torch_analysis.py holds the strict engines' gauges equal.
    eng = ServingEngine(t_cfg, tp, device="cpu", telemetry=True,
                        clock=ManualClock(tick=1e-4), verify="off", **KW)
    got = eng.generate([p.copy() for p in prompts], max_new_tokens=NEW)
    off = ServingEngine(t_cfg, tp, device="cpu", **KW)
    got_off = off.generate([p.copy() for p in prompts], max_new_tokens=NEW)
    return dict(ref=ref, want=want, eng=eng, got=got, off=off,
                got_off=got_off, prompts=prompts)


def _untraced(events):
    return [e for e in events if not e.name.startswith("trace.")]


def test_tokens_equal_the_reference(runs):
    got = [r.out_tokens for r in runs["got"]]
    assert got == [r.out_tokens for r in runs["want"]]
    assert all(len(t) == NEW for t in got)
    # The burst exercises what it is for: chunks, drafts, verify.
    m = runs["eng"].metrics
    assert m["prefill_chunks"] > len(runs["prompts"])
    assert m["draft_tokens"] > 0 and m["verify_dispatches"] > 0


def test_event_sequence_equals_the_reference(runs):
    want = _untraced(runs["ref"].obs.events)
    got = runs["eng"].obs.events
    assert [(e.name, e.track) for e in got] == [(e.name, e.track)
                                                 for e in want]
    assert len(want) < len(runs["ref"].obs.events)   # it had trace probes
    assert {e.name.split(".")[0] for e in got} >= {
        "req", "dispatch", "page", "prefix", "sched"}


@pytest.mark.parametrize("family", ["req", "dispatch", "slot", "page",
                                    "prefix", "sched"])
def test_event_args_equal_the_reference(runs, family):
    """Arguments event by event; ``slot`` are the per-slot dispatch
    mirrors (``prefill_chunk``, ``decode``, ``verify``).  Timing-valued
    arguments (``ttft_s``) read the clock, which the reference's trace
    probes advance too: compared in ``test_clock_identities``."""
    def pick(events):
        out = []
        for e in _untraced(events):
            head = e.name.split(".")[0] if "." in e.name else "slot"
            if head == family:
                out.append((e.name, e.track, e.kind,
                            {k: v for k, v in e.args.items()
                             if k != "ttft_s"}))
        return out
    want = pick(runs["ref"].obs.events)
    assert want and pick(runs["eng"].obs.events) == want


def test_counters_and_histogram_counts_equal_the_reference(runs):
    ref, eng = runs["ref"], runs["eng"]
    counters = [m.name for m in eng.registry.metrics()
                if m.kind == "counter"]
    assert counters == [m.name for m in ref.registry.metrics()
                        if m.kind == "counter"]
    for name in counters:
        if name.endswith("_traces"):
            # Programs built: the reference's jit traces (no decode program
            # on a speculative engine), none in the port.
            assert (ref.metrics[name] > 0) == (name != "decode_traces")
            assert eng.metrics[name] == 0, name
        else:
            assert eng.metrics[name] == ref.metrics[name], name
    assert set(COUNTER_NAMES) < set(counters)
    hists = [m.name for m in eng.registry.metrics() if m.kind == "histogram"]
    assert hists == [m.name for m in ref.registry.metrics()
                     if m.kind == "histogram"]
    for name in hists:
        assert (eng.metrics[f"{name}_count"]
                == ref.metrics[f"{name}_count"]), name
    assert eng.metrics["ttft_s_count"] == len(runs["prompts"])
    assert eng.metrics["chunk_latency_s_count"] == eng.metrics[
        "prefill_chunks"]
    assert eng.metrics["verify_dispatch_s_count"] == eng.metrics[
        "verify_dispatches"]


@pytest.mark.parametrize("view", ["lifetime", "last_generate"])
def test_snapshot_has_the_reference_keys(runs, view):
    ref, eng = runs["ref"], runs["eng"]
    snap = eng.snapshot(view)
    assert list(snap) == list(ref.snapshot(view))
    assert list(eng.metrics) == list(ref.metrics)
    want = ref.snapshot(view)
    # Configuration and gauges the two engines share, verbatim.
    for key in ("quant", "plan_source", "tune_table", "verified", "sharded",
                "kv_shards", "autotuned", "tune_entries", "paged",
                "chunked", "prefill_chunk", "page_size", "decode_block",
                "speculative", "draft_len", "prefix_enabled",
                "kv_bytes_reserved", "kv_bytes_peak", "pages_in_use",
                "prefix_cached_pages", "kv_bytes_cached", "accept_rate",
                "dispatches_per_token", "prefix_hit_rate", "sched_budget",
                "decode_block_last", "kv_itemsize_effective"):
        assert snap[key] == want[key], key
    if view == "lifetime":                   # repr: nan equals itself
        assert ({k: repr(v) for k, v in snap.items()}
                == {k: repr(v) for k, v in eng.metrics.items()})


def test_metrics_is_a_read_only_view(runs):
    eng = runs["eng"]
    with pytest.raises(TypeError):
        eng.metrics["generated"] = 0
    assert eng.metrics["generated"] == eng.registry["generated"].value()
    assert dict(eng.metrics)["generated"] == eng.snapshot()["generated"]


def test_clock_identities(runs):
    """``test_obs.py``'s lifecycle order on the shared clock."""
    eng, reqs = runs["eng"], runs["got"]
    n = len(reqs)
    for name in (REQ_QUEUED, REQ_ADMITTED, REQ_FIRST_TOKEN, REQ_FINISHED):
        assert eng.obs.count(name) == n, name
    assert (eng.obs.count(DISPATCH_PREFILL_CHUNK)
            == eng.metrics["prefill_chunks"])
    assert (eng.obs.count(DISPATCH_VERIFY)
            == eng.metrics["verify_dispatches"])
    by_rid = {}
    for e in eng.obs.events:
        if e.name.startswith("req."):
            by_rid.setdefault(e.args["rid"], {})[e.name] = e
    for r in reqs:
        t = {k: e.ts for k, e in by_rid[r.rid].items()}
        assert (t[REQ_QUEUED] <= t[REQ_ADMITTED]
                <= t[REQ_FIRST_TOKEN] <= t[REQ_FINISHED])
        assert t[REQ_QUEUED] == r.submitted_at
        assert t[REQ_ADMITTED] == r.admitted_at
        assert t[REQ_FIRST_TOKEN] == r.first_token_at
        assert t[REQ_FINISHED] == r.finished_at
        assert by_rid[r.rid][REQ_FIRST_TOKEN].args["ttft_s"] == round(
            r.ttft_s, 6)
        assert r.ttft_s == pytest.approx(t[REQ_FIRST_TOKEN] - t[REQ_QUEUED])
        assert 0.0 <= r.queue_wait_s <= r.ttft_s <= r.latency_s
        assert r.tpot_s >= 0.0
    t_lo = min(e.ts for e in eng.obs.events)
    t_hi = max(e.end for e in eng.obs.events)
    for e in eng.obs.events:
        assert t_lo <= e.ts <= e.end <= t_hi
    trace = chrome_trace(eng.obs.events)
    assert validate_chrome_trace(trace) == []
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    assert {"engine", "sched", "kv", "prefix", "slot0", "slot1"} <= lanes


def test_telemetry_off_is_a_pure_observer(runs):
    off = runs["off"]
    assert [r.out_tokens for r in runs["got_off"]] == [
        r.out_tokens for r in runs["got"]]
    assert off.obs is NULL_RECORDER and off.obs.events == ()
    assert off.kv.obs is NULL_RECORDER and off.prefix.obs is NULL_RECORDER
    for name in COUNTER_NAMES:
        assert off.metrics[name] == runs["eng"].metrics[name], name
    assert off.metrics["ttft_s_count"] == len(runs["prompts"])


def test_demo_returns_zero_and_writes_its_files(tmp_path, capsys):
    """``python -m repro_torch.obs --demo --device cpu`` in-process: the
    reference demo's engine (reduced gpt2, float32, chunked +
    speculative) and its checks, all passing."""
    from repro_torch.obs.__main__ import main
    out = tmp_path / "obs_demo"
    assert main(["--demo", "--device", "cpu", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "FAIL" not in text and "all checks passed" in text
    trace = json.loads((out / "trace.json").read_text())
    assert validate_chrome_trace(trace) == []
    lines = (out / "events.jsonl").read_text().splitlines()
    assert len(lines) == sum(e["ph"] != "M" for e in trace["traceEvents"])
    prom = (out / "metrics.prom").read_text()
    assert "repro_ttft_s_bucket{" in prom
    assert 'repro_info{quant="none",plan_source="analytic",' in prom
    assert main([]) == 2                    # no --demo: help, exit 2
