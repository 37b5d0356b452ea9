"""The port's metric windows and rejection semantics, against
``repro.serving.ServingEngine(telemetry=True, verify="off")`` on the CPU.

Whole-prompt admission over the contiguous slot cache (``paged=False``) on
reduced gpt2 in float32 (kernel plan, weights jittered), 2 slots,
``max_len`` 96, ``ManualClock(tick=1e-4)`` on both sides.  A first
``generate`` holds an over-long prompt between two good ones; a second
serves two more prompts.

* the rejected request: a ``req.rejected`` event with the reference's
  arguments, ``nan`` ``ttft_s``, ``queue_wait_s`` and ``tpot_s``, a finite
  ``latency_s``; ``ttft_s_count`` counts only the served requests;
* ``snapshot("lifetime")`` and ``snapshot("last_generate")`` after each
  call equal the JAX engine's key for key, except the timing-valued
  histogram fields (``_mean``, ``_p50``, ``_p90``, ``_p99``: the
  reference's trace probes advance its clock) and the trace probes
  themselves (programs built: none in the port);
* the event sequence and arguments equal the reference's, ``trace.*``
  removed, and the dispatch spans are whole-prompt prefills and decode
  blocks;
* the contiguous engine's ``kv_bytes_peak`` is its reserved bytes.
"""

import dataclasses
import math

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
from repro_torch.obs import (DISPATCH_DECODE, DISPATCH_PREFILL,
                             REQ_REJECTED, ManualClock)
from repro_torch.serving import ServingEngine

KW = dict(batch_slots=2, max_len=96, decode_block=4, paged=False)
NEW = 4
TIMED = ("_mean", "_p50", "_p90", "_p99")


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


def _bursts(vocab):
    rng = np.random.default_rng(33)
    first = [rng.integers(1, vocab, 11).astype(np.int32),
             np.ones(97, np.int32),                     # > max_len
             rng.integers(1, vocab, 30).astype(np.int32)]
    second = [rng.integers(1, vocab, 7).astype(np.int32),
              rng.integers(1, vocab, 19).astype(np.int32)]
    return first, second


def _serve(eng, bursts):
    """Each burst in turn; the requests and both snapshots after each."""
    out = []
    for prompts in bursts:
        reqs = eng.generate([p.copy() for p in prompts], max_new_tokens=NEW)
        out.append((reqs, eng.snapshot("lifetime"),
                    eng.snapshot("last_generate")))
    return out


@pytest.fixture(scope="module")
def runs():
    j_cfg, t_cfg = _configs()
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(3), j_cfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                           device="cpu")
    bursts = _bursts(t_cfg.vocab_size)
    ref = JServingEngine(j_cfg, jp, verify="off", telemetry=True,
                         clock=JManualClock(tick=1e-4), **KW)
    # Both engines skip the plan verifier (``verified`` 0 on both sides);
    # test_torch_analysis.py holds the strict engines' gauges equal.
    eng = ServingEngine(t_cfg, tp, device="cpu", telemetry=True,
                        clock=ManualClock(tick=1e-4), verify="off", **KW)
    return dict(ref=ref, want=_serve(ref, bursts), eng=eng,
                got=_serve(eng, bursts))


def test_tokens_equal_the_reference(runs):
    for (got, _, _), (want, _, _) in zip(runs["got"], runs["want"]):
        assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
        assert [r.failed for r in got] == [r.failed for r in want]


def test_rejection_nan_semantics_and_event(runs):
    eng = runs["eng"]
    reqs, life, win = runs["got"][0]
    r = reqs[1]
    assert r.failed and r.done and "exceeds max_len" in r.error
    assert math.isnan(r.ttft_s) and math.isnan(r.tpot_s)
    assert math.isnan(r.queue_wait_s)            # never admitted
    assert math.isfinite(r.latency_s) and r.latency_s >= 0.0
    assert eng.obs.count(REQ_REJECTED) == 1
    ev = next(e for e in eng.obs.events if e.name == REQ_REJECTED)
    want = next(e for e in runs["ref"].obs.events if e.name == REQ_REJECTED)
    assert (ev.track, ev.args) == (want.track, want.args)
    assert ev.ts == r.finished_at
    assert win["rejected"] == life["rejected"] == 1
    # The nan TTFT never lands: only the served requests count.
    assert win["ttft_s_count"] == win["queue_wait_s_count"] == 2
    assert all(q.out_tokens and not q.failed for q in (reqs[0], reqs[2]))


@pytest.mark.parametrize("call", [0, 1])
@pytest.mark.parametrize("view", ["lifetime", "last_generate"])
def test_windows_equal_the_reference(runs, call, view):
    got = runs["got"][call][1 if view == "lifetime" else 2]
    want = runs["want"][call][1 if view == "lifetime" else 2]
    assert list(got) == list(want)
    for key, value in want.items():
        if key.endswith(TIMED) and key[:key.rindex("_")] + "_count" in want:
            continue
        if key.endswith("_traces"):
            assert got[key] == 0, key
            continue
        assert got[key] == value, key
    if call == 1:
        first = runs["got"][0][1]
        assert got["generated"] == (first["generated"] + 2 * NEW
                                    if view == "lifetime" else 2 * NEW)
        assert got["ttft_s_count"] == (4 if view == "lifetime" else 2)


def test_windowed_percentiles_come_from_the_window(runs):
    """Timing values are the port's own: a window's histograms count that
    call's observations alone and their percentiles are ordered."""
    for _, life, win in runs["got"]:
        for h in ("ttft_s", "tpot_s", "prefill_dispatch_s",
                  "decode_dispatch_s"):
            assert win[f"{h}_count"] <= life[f"{h}_count"]
            for snap in (life, win):
                assert (snap[f"{h}_p50"] <= snap[f"{h}_p90"]
                        <= snap[f"{h}_p99"]), h
    last = runs["got"][1][2]
    assert last["prefill_dispatch_s_count"] == 2
    assert last["chunk_latency_s_count"] == 0
    assert math.isnan(last["chunk_latency_s_p50"])


def test_events_equal_the_reference(runs):
    def seq(events):
        return [(e.name, e.track, e.kind,
                 {k: v for k, v in e.args.items() if k != "ttft_s"})
                for e in events if not e.name.startswith("trace.")]
    eng = runs["eng"]
    assert seq(eng.obs.events) == seq(runs["ref"].obs.events)
    assert eng.obs.count(DISPATCH_PREFILL) == eng.metrics["prefills"] == 4
    assert eng.obs.count(DISPATCH_DECODE) == eng.metrics["dispatches"]
    assert not any(e.name.startswith(("page.", "prefix."))
                   for e in eng.obs.events)


def test_contiguous_bytes(runs):
    life = runs["got"][1][1]
    assert life["paged"] == 0 and life["page_size"] == 0
    assert life["kv_bytes_peak"] == life["kv_bytes_reserved"] > 0
