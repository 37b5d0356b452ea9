"""``ServingEngine(autotune=...)`` of the port against the reference's
engine with ``autotune=``, on the CPU.

Reduced llama3-8b in float32 on the kernel plan, weights jittered
(``repro.serving.accuracy.jitter_params`` before ``np.asarray``), 2
slots, ``max_len`` 64, chunked prefill with the prefix cache (the
defaults), three prompts.  The JAX engine's run is shared by the module.

* The first start tunes and writes the table; the second start over the
  same file makes zero measurements, resolves an equal plan, serves its
  lookups from the table and decodes equal tokens.
* The tuned engine's greedy tokens equal the JAX engine's with
  ``autotune=`` and the untuned engine's.
* The tuned plan's page size and prefill chunk are the pools' and the
  chunker's, and the plan passes the strict verifier first (a tuned plan
  the verifier refuses raises before anything is allocated).
* The tuner's counters, gauges and ``tune.measure`` events; a degraded
  table warns; ``autotune=True`` keeps its table under
  ``$REPRO_TORCH_TUNE_DIR``.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.serving import ServingEngine as JServingEngine
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro_torch.analysis import PlanVerificationError
from repro_torch.configs import get_config
from repro_torch.core.stream_plan import plan_for
from repro_torch.models import params_from_numpy
from repro_torch.obs import TUNE_MEASURE, TUNE_PRUNE
from repro_torch.serving import ServingEngine
from repro_torch.tuning import Tuner

KW = dict(batch_slots=2, max_len=64)
NEW = 6


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
    return (dataclasses.replace(j_get_config("llama3-8b").reduced(), **kw),
            dataclasses.replace(get_config("llama3-8b").reduced(), **kw))


PROMPTS = [np.arange(1, 9, dtype=np.int32),
           np.arange(3, 40, dtype=np.int32) % 50,
           np.arange(5, 12, dtype=np.int32)]


def _tokens(eng):
    return [r.out_tokens for r in eng.generate([p.copy() for p in PROMPTS],
                                               max_new_tokens=NEW)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX engine with ``autotune=``, and the port's: tuned twice over
    one table (the plan cache cleared before each start, a fresh process's
    stand-in) and untuned."""
    tmp = tmp_path_factory.mktemp("tune")
    j_cfg, cfg = _configs()
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(0), j_cfg), seed=1)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
    ref = JServingEngine(j_cfg, jp, autotune=str(tmp / "j.json"), **KW)
    want = [r.out_tokens for r in ref.generate([p.copy() for p in PROMPTS],
                                               max_new_tokens=NEW)]
    path = str(tmp / "t.json")
    plan_for.cache_clear()
    eng1 = ServingEngine(cfg, params, autotune=path, device="cpu", **KW)
    got1 = _tokens(eng1)
    plan_for.cache_clear()
    eng2 = ServingEngine(cfg, params, autotune=path, device="cpu", **KW)
    got2 = _tokens(eng2)
    base = ServingEngine(cfg, params, device="cpu", **KW)
    got_base = _tokens(base)
    return dict(cfg=cfg, params=params, ref=ref, want=want, path=path,
                eng1=eng1, got1=got1, eng2=eng2, got2=got2, base=base,
                got_base=got_base, tmp=tmp)


def test_first_start_tunes_and_persists(runs):
    eng = runs["eng1"]
    assert os.path.exists(runs["path"])
    st = eng.tuner.stats
    assert st.measured > 0 and st.stages > 0
    assert st.candidates >= st.pruned + st.measured
    m = eng.metrics
    assert m["autotuned"] == 1 and m["tune_table"] == runs["path"]
    assert m["tune_entries"] == len(eng.tuner.table) > 0
    assert m["tune_measured"] == st.measured
    assert m["tune_misses"] == eng.tuner.table.misses > 0
    assert m["tune_pruned"] == st.pruned
    assert m["plan_source"] == eng.plan.cost_source == "analytic"
    assert eng.tuner.table.backend == "cpu:plain"
    assert eng.tuner.device.type == "cpu"


def test_second_start_reuses_the_table(runs):
    eng1, eng2 = runs["eng1"], runs["eng2"]
    assert eng2.tuner.stats.measured == 0
    assert eng2.metrics["tune_measured"] == 0
    assert eng2.metrics["tune_hits"] == eng2.tuner.table.hits > 0
    assert eng1.plan == eng2.plan
    assert runs["got1"] == runs["got2"]


def test_tokens_equal_the_jax_engine_and_the_untuned_engine(runs):
    assert runs["got1"] == runs["want"]
    assert runs["got1"] == runs["got_base"]
    assert all(len(t) == NEW for t in runs["got1"])
    ref = runs["ref"]
    assert ref.metrics["autotuned"] == 1 and ref.tuner.stats.measured > 0


def test_the_tuned_granules_drive_the_pools(runs):
    """The tuned plan (64-token pages: the surrogate's largest legal
    page) sizes the pools and the chunker, as the reference's tuned
    engine; the untuned plan's page differs; both verified strictly."""
    eng, base, ref = runs["eng1"], runs["base"], runs["ref"]
    ps = eng.plan.decode_page_size()
    assert ps == 64 != base.plan.decode_page_size()
    assert eng.kv.page_size == eng.metrics["page_size"] == ps
    want = min(eng.plan.prefill_chunk_size(ps), eng.kv.extent)
    assert eng.chunk == eng.metrics["prefill_chunk"] == max(ps, want)
    assert (eng.metrics["page_size"], eng.metrics["prefill_chunk"]) == (
        ref.metrics["page_size"], ref.metrics["prefill_chunk"])
    assert eng.plan.verified is True and eng.metrics["verified"] == 1
    assert base.plan.verified is True


def test_a_tuned_plan_is_verified_before_allocation(runs, monkeypatch):
    """A tuned plan the verifier refuses (an int8-weight flag on a config
    without weight quantization) raises strictly, before the pools
    exist."""
    class BadTuner(Tuner):
        def tune_plan(self, cfg, plan, **kw):
            ffn = plan.layer("attn").ffn
            return plan.with_stage("attn", "ffn", dataclasses.replace(
                ffn, blocks=ffn.blocks + (("w8", 1),)))

    import repro_torch.serving.engine as E
    made = []
    real = E.PagedKVCache
    monkeypatch.setattr(E, "PagedKVCache",
                        lambda *a, **k: made.append(1) or real(*a, **k))
    plan_for.cache_clear()
    with pytest.raises(PlanVerificationError) as err:
        ServingEngine(runs["cfg"], runs["params"],
                      autotune=BadTuner(device="cpu"), device="cpu", **KW)
    assert "w8-without-weight-quant" in {d.code
                                         for d in err.value.diagnostics}
    assert not made


def test_tuner_events_with_telemetry(runs, tmp_path):
    plan_for.cache_clear()
    eng = ServingEngine(runs["cfg"], runs["params"], telemetry=True,
                        autotune=str(tmp_path / "t.json"), device="cpu", **KW)
    names = [e.name for e in eng.obs.events]
    assert names.count(TUNE_MEASURE) == eng.tuner.stats.measured > 0
    assert names.count(TUNE_PRUNE) == eng.tuner.stats.pruned
    assert {e.track for e in eng.obs.events
            if e.name.startswith("tune.")} == {"tune"}


def test_a_degraded_table_warns(runs, tmp_path):
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        f.write("not json at all")
    plan_for.cache_clear()
    with pytest.warns(UserWarning, match="autotune table degraded"):
        eng = ServingEngine(runs["cfg"], runs["params"], autotune=path,
                            device="cpu", **KW)
    assert eng.tuner.stats.measured > 0        # re-tuned from nothing
    assert _tokens(eng) == runs["got1"]


def test_autotune_true_uses_the_default_directory(runs, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_DIR", str(tmp_path / "tables"))
    plan_for.cache_clear()
    eng = ServingEngine(runs["cfg"], runs["params"], autotune=True,
                        device="cpu", **KW)
    want = str(tmp_path / "tables" / f"{runs['cfg'].name}.json")
    assert eng.metrics["tune_table"] == want and os.path.exists(want)


@pytest.mark.parametrize("arch", ["gpt2", "llama3-8b"])
def test_round_trip_cli(arch, capsys):
    """``python -m repro_torch.tuning --device cpu`` in-process: the
    reduced config's round trip passes and reports what it did."""
    import json

    from repro_torch.tuning.__main__ import main
    assert main(["--arch", arch, "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["ok"] and stats["backend"] == "cpu:plain"
    assert stats["measured_first_start"] > 0
    assert stats["measured_second_start"] == 0
    assert stats["page_size"] == 64 and stats["sources"] == ["analytic"]
