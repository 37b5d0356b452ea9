"""The port's autotuner (``repro_torch.tuning``) against the reference's
(``repro.tuning``), on the CPU.

* The table: round trip, keys byte-equal to the reference's and blind to
  field order, concurrent writers, the degraded loads (corrupt, wrong
  version, wrong backend: a reference-written table among them), frozen
  mode, the backend fingerprints.
* The surrogate, the candidates and the tuned plans equal the reference's
  on ``H100``'s constants (``J_H100``) for every reduced registry config.
  The two kernel lints differ in their block rule (ROADMAP queue 3, "the
  kernel lint's block rule"): a ``block_kv`` of whole 128-wide tiles that
  does not divide the KV length passes the port's lint and draws the
  reference's ``non-divisible-block`` warning.  Where that makes the
  pruned sets differ (``LINT_DIFFERS``), the port's pick is the argmin over
  its own legal set.
* Frozen tables, the verify stage's page size, measurement (the surrogate
  on the CPU unless forced), a card tuner refusing this host, the card's
  signature (hint-only candidates collapse; checked against the wrapper
  signatures, a fake library's C arguments and the plan's granules),
  ``resolve_tuner``, ``use_tuner`` reaching ``plan_for``, and the tuned
  registry plans verifying clean.
"""

import dataclasses
import importlib
import inspect
import json
import math
import os
import threading
import types

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.stream_plan import build_stream_plan as j_build_stream_plan
from repro.tuning import TuneEntry as JTuneEntry
from repro.tuning import TuneTable as JTuneTable
from repro.tuning import Tuner as JTuner
from repro.tuning import analytic_estimate as j_analytic_estimate
from repro.tuning import enumerate_candidates as j_enumerate_candidates
from repro.tuning import make_key as j_make_key
from repro_torch import kernels as K
from repro_torch.analysis import clean, verify_plan
from repro_torch.analysis.kernel_lint import check_kernels
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import H100
from repro_torch.core.stream_plan import (KernelChoice, build_stream_plan,
                                          plan_for)
from repro_torch.kernels import _build
from repro_torch.tuning import (SCHEMA_VERSION, TuneEntry, TuneTable, Tuner,
                                analytic_estimate, backend_fingerprint,
                                card_blocks, enumerate_candidates, make_key,
                                measure, measure_candidate, resolve_tuner,
                                use_tuner)
from repro_torch.tuning.autotune import _FAMILY_MODULES, _signature

from test_torch_stream_plan import J_H100, _fields
from test_torch_tensorcore import _FakeLib


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = backend_fingerprint("cpu")
# (tokens, kv_len): an engine's decode plan over 1000 positions, a chunk's.
SHAPES = ((4, 1000), (128, 1024))
ARCH_IDS = sorted(ARCHS)


def _configs(arch, quant="none", full=False):
    base, j_base = get_config(arch), j_get_config(arch)
    if not full:
        base, j_base = base.reduced(), j_base.reduced()
    over = dict(use_fused_kernels=True, quant=quant)
    return (dataclasses.replace(base, **over),
            dataclasses.replace(j_base, **over))


def _plans(arch, tokens, kv_len, quant="none"):
    cfg, j_cfg = _configs(arch, quant)
    return (cfg, build_stream_plan(cfg, tokens=tokens, kv_len=kv_len),
            j_cfg, j_build_stream_plan(j_cfg, tokens=tokens, kv_len=kv_len,
                                       platform=J_H100))


def _tuned_stages(plan):
    return [(k, s, c) for k, s, c in plan.stage_choices()
            if c.fused and s != "verify_attn"]


# ------------------------------------------------------------ table

def test_table_round_trip(tmp_path):
    path = str(tmp_path / "t.json")
    t = TuneTable(path=path, backend=CPU)
    key = make_key("streamed_ffn", shape=(("t", 4), ("d", 64)),
                   dtype="float32", quant="none", mesh_axes=(),
                   blocks=(("block_t", 256), ("block_f", 128)))
    t.put(key, TuneEntry(latency_s=1.5e-4, source="measured"))
    t.save()
    back = TuneTable.load(path, device="cpu")
    assert not back.diagnostics and back.backend == "cpu:plain"
    assert len(back) == 1
    got = back.get(key)
    assert got == TuneEntry(latency_s=1.5e-4, source="measured")
    assert back.hits == 1 and back.misses == 0
    assert back.get("no-such-key") is None and back.misses == 1
    with open(path) as fh:
        raw = json.load(fh)
    assert raw["version"] == SCHEMA_VERSION and raw["backend"] == CPU


def test_table_keys_equal_the_reference_keys():
    """Byte-equal to ``repro.tuning.make_key`` for equal inputs, and the
    same whatever the order of each group's fields."""
    cases = [
        ("k", (("t", 4), ("d", 8)), "f32", "none", (), (("x", 1), ("y", 2))),
        ("paged_attention", (("t", 4), ("s", 1000), ("hkv", 8)),
         "bfloat16", "w8_kv8", (("model", 4), ("data", 2)),
         (("page_size", 64),)),
        ("streamed_ffn", (("t", 128), ("f", 14336), ("d", 4096)), "float32",
         "w8", (), (("block_t", 128), ("block_f", 512), ("fuse_norm", 1),
                    ("w8", 1)))]
    for kernel, shape, dtype, quant, mesh, blocks in cases:
        mine = make_key(kernel, shape=shape, dtype=dtype, quant=quant,
                        mesh_axes=mesh, blocks=blocks)
        assert mine == j_make_key(kernel, shape=shape, dtype=dtype,
                                  quant=quant, mesh_axes=mesh, blocks=blocks)
        assert mine == make_key(kernel, shape=shape[::-1], dtype=dtype,
                                quant=quant, mesh_axes=mesh[::-1],
                                blocks=blocks[::-1])


def test_table_concurrent_writers_leave_valid_json(tmp_path):
    """Atomic replace: racing saves each leave a complete, parseable file
    and no temp file behind."""
    path = str(tmp_path / "t.json")
    errs = []

    def writer(i):
        try:
            t = TuneTable(path=path, backend=CPU)
            for j in range(20):
                t.put(f"w{i}.e{j}", TuneEntry(latency_s=float(j + 1)))
                t.save()
        except Exception as e:         # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs
    back = TuneTable.load(path, device="cpu")
    assert not back.diagnostics
    assert len(back) == 20               # one writer's complete last save
    assert os.listdir(str(tmp_path)) == ["t.json"]


def _blob(path, **over):
    blob = {"version": SCHEMA_VERSION, "backend": CPU,
            "entries": {"k": {"latency_s": 1.0, "source": "measured",
                              "samples": 1}}}
    blob.update(over)
    with open(path, "w") as f:
        json.dump(blob, f)


@pytest.mark.parametrize("defect,code", [
    ("corrupt", "table-corrupt"), ("entries", "table-corrupt"),
    ("version", "table-version"), ("backend", "table-backend"),
    ("card", "table-backend")])
def test_a_defective_table_degrades_with_its_warning(tmp_path, defect, code):
    """A corrupt file, malformed entries, another schema version, another
    backend (the reference's ``cpu:interpret``, a card's) each load as an
    EMPTY table with the matching warning; a fill and save then replace
    the wreck."""
    path = str(tmp_path / "t.json")
    if defect == "corrupt":
        with open(path, "w") as f:
            f.write("{ this is not json")
    elif defect == "entries":
        _blob(path, entries={"k": {"source": "measured"}})
    elif defect == "version":
        _blob(path, version=SCHEMA_VERSION + 1)
    elif defect == "backend":
        _blob(path, backend="cpu:interpret")
    else:
        _blob(path, backend="cuda:NVIDIA H100 80GB HBM3:sm_90")
    t = TuneTable.load(path, device="cpu")
    assert len(t) == 0
    assert [(d.severity, d.code) for d in t.diagnostics] == [("warning",
                                                              code)]
    t.put("k", TuneEntry(latency_s=1.0))
    t.save()
    assert not TuneTable.load(path, device="cpu").diagnostics


def test_a_reference_written_table_is_refused(tmp_path):
    """The reference stamps its JAX backend (``cpu:interpret`` here): the
    port's CPU tuner sees another backend, loads nothing and re-tunes."""
    path = str(tmp_path / "j.json")
    jt = JTuneTable(path=path)
    jt.put("k", JTuneEntry(latency_s=1.0, source="analytic"))
    jt.save()
    t = TuneTable.load(path, device="cpu")
    assert len(t) == 0
    assert [d.code for d in t.diagnostics] == ["table-backend"]
    assert jt.backend in t.diagnostics[0].message
    cfg, _ = _configs("gpt2")
    tuner = resolve_tuner(path, cfg, device="cpu")
    assert len(tuner.table) == 0 and tuner.table.diagnostics


def test_frozen_table_rejects_writes(tmp_path):
    t = TuneTable(path=str(tmp_path / "t.json"), backend=CPU, frozen=True)
    with pytest.raises(RuntimeError):
        t.put("k", TuneEntry(latency_s=1.0))
    with pytest.raises(RuntimeError):
        t.save()


def test_backend_fingerprints():
    assert backend_fingerprint("cpu") == "cpu:plain"
    if not torch.cuda.is_available():
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                backend_fingerprint(device)
        with pytest.raises(RuntimeError):
            TuneTable()                 # the default backend is the card's


# --------------------------------------------- surrogate and candidates

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_estimate_equals_the_reference(arch):
    """Every candidate of every stage (verify's too) at two shapes, under
    the plain and the ``w8_kv8`` plans: the same seconds."""
    n = 0
    for quant in ("none", "w8_kv8"):
        for tokens, kv_len in SHAPES:
            cfg, plan, j_cfg, j_plan = _plans(arch, tokens, kv_len, quant)
            for (k, s, c), (_, _, jc) in zip(plan.stage_choices(),
                                             j_plan.stage_choices()):
                if not c.fused:
                    continue
                for cand in enumerate_candidates(cfg, plan, s, c, "cpu"):
                    jcand = type(jc)(cand.implementation, cand.blocks)
                    got = analytic_estimate(cfg, plan, s, cand, H100)
                    want = j_analytic_estimate(j_cfg, j_plan, s, jcand,
                                               J_H100)
                    assert math.isclose(got, want, rel_tol=1e-12), (k, s)
                    n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_enumerate_candidates_equals_the_reference(arch):
    """On the CPU: the same candidates in the same order, the original
    first, no two with one signature, flags carried unchanged."""
    for tokens, kv_len in SHAPES:
        cfg, plan, j_cfg, j_plan = _plans(arch, tokens, kv_len)
        for (k, s, c), (_, _, jc) in zip(_tuned_stages(plan),
                                         _tuned_stages(j_plan)):
            mine = enumerate_candidates(cfg, plan, s, c, device="cpu")
            ref = j_enumerate_candidates(j_cfg, j_plan, s, jc)
            assert [m.blocks for m in mine] == [r.blocks for r in ref], (
                k, s)
            assert mine[0] == c
            sigs = [_signature(cfg, plan, s, m, "cpu") for m in mine]
            assert len(sigs) == len(set(sigs))
            for m in mine:
                assert m.implementation == c.implementation
                assert m.block("fuse_norm") == c.block("fuse_norm")
                assert m.block("w8") == c.block("w8")


# Where the two lints disagree on the reduced configs at ``SHAPES``:
# (tokens, kv_len, stage).  At 1000 positions ``block_kv`` 256 and 512
# (whole 128-wide tiles) do not divide the KV length: the reference's lint
# warns (non-divisible-block) and prunes them, the port's passes them.
LINT_DIFFERS = {(4, 1000, "attention")}


def _port_argmin(cfg, plan, kind, stage, choice):
    """The port's pick by hand: the lowest surrogate over the original and
    the candidates its own lint passes (ties keep the earlier)."""
    best, best_lat = None, math.inf
    for i, cand in enumerate(enumerate_candidates(cfg, plan, stage, choice,
                                                  "cpu")):
        swapped = plan.with_stage(kind, stage, cand)
        bad = any(d.severity in ("error", "warning")
                  and d.stage == f"{kind}.{stage}"
                  for d in check_kernels(swapped, cfg, H100, device="cpu"))
        if i > 0 and bad:
            continue
        lat = analytic_estimate(cfg, plan, stage, cand, H100)
        if lat < best_lat:
            best, best_lat = cand, lat
    return best


@pytest.mark.parametrize("mode", ["analytic", "hybrid"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tuned_plan_equals_the_reference(arch, mode):
    """``build_stream_plan(tune=Tuner(mode=..., device="cpu"))`` against
    the reference's tuner on the same constants: field for field, except
    the stages the lints' block rule separates (``LINT_DIFFERS``), where
    the port's pick is its own legal argmin and the reference's pick is
    among the port's candidates."""
    for tokens, kv_len in SHAPES:
        cfg, j_cfg = _configs(arch)
        tuner, j_tuner = Tuner(mode=mode, device="cpu"), JTuner(mode=mode)
        mine = build_stream_plan(cfg, tokens=tokens, kv_len=kv_len,
                                 tune=tuner)
        ref = j_build_stream_plan(j_cfg, tokens=tokens, kv_len=kv_len,
                                  platform=J_H100, tune=j_tuner)
        base = build_stream_plan(cfg, tokens=tokens, kv_len=kv_len)
        assert tuner.stats.candidates == j_tuner.stats.candidates
        assert tuner.stats.stages == j_tuner.stats.stages
        fm, fr = _fields(mine), _fields(ref)
        differs = set()
        for (kind, lm), (_, lr) in zip(fm.pop("layers"), fr.pop("layers")):
            for (stage, cm), (_, cr) in zip(lm, lr):
                if cm == cr:
                    continue
                differs.add((tokens, kv_len, stage))
                assert (tokens, kv_len, stage) in LINT_DIFFERS, (kind, stage)
                pick = _port_argmin(cfg, base, kind, stage,
                                    getattr(base.layer(kind), stage))
                assert cm[:2] == (pick.implementation, pick.blocks)
                assert cr[1] in [c.blocks for c in enumerate_candidates(
                    cfg, base, stage, getattr(base.layer(kind), stage),
                    "cpu")]
        assert fm == fr
        if differs:
            assert tuner.stats.pruned < j_tuner.stats.pruned
        else:
            assert tuner.stats.pruned == j_tuner.stats.pruned
        if mode == "hybrid":
            assert tuner.stats.measured == len(tuner.table) > 0
        else:
            assert tuner.stats.measured == 0 and len(tuner.table) == 0


def test_the_tuned_engine_plans_take_64_token_pages():
    """At an engine's shapes the surrogate moves llama3-8b's and gpt2's
    paged stages to the lattice's largest page (its cost has one pipeline
    fill per page at the same bytes), full width and reduced; the prefill
    chunk follows as ``prefill_chunk_size(64)``."""
    for arch in ("llama3-8b", "gpt2"):
        for full in (False, True):
            cfg, _ = _configs(arch, full=full)
            for tokens, kv_len in ((4, 1000), (128, 1024)):
                plan = build_stream_plan(cfg, tokens=tokens, kv_len=kv_len,
                                         tune=Tuner(device="cpu"))
                assert plan.decode_page_size() == 64, (arch, full, tokens)
                for _, lp in plan.layers:
                    assert lp.verify_attn.block("page_size") == 64
                assert plan.prefill_chunk_size(64) == 128


# ------------------------------------------------------------ tuner

def test_tuner_deterministic_and_frozen_table_reproducible(tmp_path):
    path = str(tmp_path / "t.json")
    cfg, _ = _configs("gpt2")
    p1 = build_stream_plan(cfg, tokens=4, kv_len=64,
                           tune=Tuner(TuneTable(path=path, backend=CPU)))
    assert os.path.exists(path)
    frozen = TuneTable.load(path, frozen=True, device="cpu")
    t2, t3 = Tuner(frozen), Tuner(TuneTable.load(path, device="cpu"))
    assert t2.device.type == t3.device.type == "cpu"
    p2 = build_stream_plan(cfg, tokens=4, kv_len=64, tune=t2)
    p3 = build_stream_plan(cfg, tokens=4, kv_len=64, tune=t3)
    assert p1 == p2 == p3
    assert t2.stats.measured == 0 and t2.table.hits > 0
    assert t3.stats.measured == 0 and not t3.table.dirty
    # The measured-only mode skips what the table has not seen.
    t4 = Tuner(TuneTable(backend=CPU), mode="measured")
    assert build_stream_plan(cfg, tokens=4, kv_len=64,
                             tune=t4) == build_stream_plan(cfg, tokens=4,
                                                           kv_len=64)
    assert t4.stats.measured == 0 and t4.table.misses > 0


def test_tuner_stamps_sources_and_syncs_verify_pages():
    """Forced measurement on the CPU times the plain versions of the five
    driver families (``measured``); the paged stage keeps the surrogate,
    so the plan is ``hybrid``; verify takes decode's page size."""
    cfg, _ = _configs("llama3-8b")
    plan = build_stream_plan(cfg, tokens=8, kv_len=64)
    tuner = Tuner(force_measure=True, device="cpu")
    tuned = tuner.tune_plan(cfg, plan)
    srcs = {f"{k}.{s}": c.source for k, s, c in tuned.stage_choices()
            if c.fused}
    assert srcs == {"attn.qkv": "measured", "attn.attention": "measured",
                    "attn.decode_attn": "analytic",
                    "attn.verify_attn": "analytic",
                    "attn.ffn": "measured", "final.lm_head": "measured"}
    assert tuned.cost_source == "hybrid"
    for _, lp in tuned.layers:
        assert (lp.verify_attn.block("page_size")
                == lp.decode_attn.block("page_size"))
    summ = tuned.summary()
    assert summ["plan_source"] == "hybrid" and summ["stage_sources"]
    assert tuner.tune_plan(cfg, plan) is tuned        # memoized


def test_measure_candidate_is_the_surrogate_on_the_cpu_unless_forced():
    cfg, _ = _configs("gpt2")
    plan = build_stream_plan(cfg, tokens=4, kv_len=64)
    for kind, stage, choice in _tuned_stages(plan):
        lat, src = measure_candidate(cfg, plan, kind, stage, choice,
                                     platform=H100, device="cpu")
        assert (lat, src) == (analytic_estimate(cfg, plan, stage, choice,
                                                H100), "analytic")
        lat, src = measure_candidate(cfg, plan, kind, stage, choice,
                                     platform=H100, device="cpu",
                                     force=True, reps=2)
        timed = choice.implementation != "paged_attention"
        assert src == ("measured" if timed else "analytic") and lat > 0


def test_measure_times_the_calls():
    calls = []

    def fn():
        calls.append(1)
        return np.zeros(1)

    assert measure(fn, "cpu", reps=3, warmup=1) >= 0.0
    assert len(calls) == 4               # warmup + reps


def test_a_card_tuner_refuses_this_host():
    """No fallback to the CPU: a tuner for the card raises without one,
    and so do the entry points that default to the card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg, _ = _configs("gpt2")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Tuner(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_stream_plan(cfg, tokens=4, tune=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_tuner(True, cfg)
    with pytest.raises(ValueError, match="backend"):
        Tuner(TuneTable(backend="cuda:NVIDIA H100 80GB HBM3:sm_90"),
              device="cpu")


# ------------------------------------------------- the card's signature

@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2", "granite-moe-3b-a800m",
                                  "zamba2-2.7b", "rwkv6-7b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_card_signature_collapses_hint_only_candidates(arch, dtype):
    """Full width, the card's lint alone (nothing launches): at an engine's
    decode shape every stage but the paged one (and float32 zamba2's SSD
    chunk) is one candidate on the card; the paged stage keeps the page
    lattice; each card candidate is among the CPU's and legal on the
    card."""
    cfg, _ = _configs(arch, full=True)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    plan = build_stream_plan(cfg, tokens=4, kv_len=2048)
    for kind, stage, choice in _tuned_stages(plan):
        card = enumerate_candidates(cfg, plan, stage, choice, "cuda")
        cpu = enumerate_candidates(cfg, plan, stage, choice, "cpu")
        assert card[0] == choice and len(card) <= len(cpu)
        assert [c.blocks for c in card] == [
            c.blocks for c in cpu if c.blocks in {x.blocks for x in card}]
        keep = card_blocks(choice.implementation, dtype)
        if choice.implementation == "paged_attention":
            assert keep == ("page_size",)
            assert sorted(c.block("page_size") for c in card) == sorted(
                {choice.block("page_size"), 8, 16, 32, 64})
        elif choice.implementation == "mamba2_scan" and dtype == "float32":
            assert keep == ("chunk",)      # clipped at 4 tokens: one
            assert len(card) == 1
        else:
            assert len(card) == 1, (kind, stage)
        for cand in card:
            swapped = plan.with_stage(kind, stage, cand)
            assert not [d for d in check_kernels(swapped, cfg, H100,
                                                 device="cuda")
                        if d.severity in ("error", "warning")
                        and d.stage == f"{kind}.{stage}"]
    # At a training shape the chunk-sensitive names still separate.
    big = build_stream_plan(cfg, tokens=4096, kv_len=4096)
    for kind, stage, choice in _tuned_stages(big):
        card = enumerate_candidates(cfg, big, stage, choice, "cuda")
        names = set(card_blocks(choice.implementation, dtype))
        if not names & {n for n, _ in choice.blocks}:
            assert len(card) == 1, (kind, stage)


# Each wrapper a family's stage calls, and the TUNE_SPACE names the card
# would have to take to run another program.
WRAPPERS = {
    "rmsnorm_matmul": (K.rmsnorm_matmul, K.rmsnorm_matmul_w8),
    "block_matmul": (K.block_matmul,),
    "flash_attention": (K.flash_attention_2d, K.flash_attention_static,
                        K.flash_attention_2d_q),
    "paged_attention": (K.paged_decode_attention, K.paged_verify_attention,
                        K.paged_decode_attention_q,
                        K.paged_verify_attention_q),
    "streamed_ffn": (K.streamed_ffn, K.streamed_mlp, K.streamed_ffn_w8,
                     K.streamed_mlp_w8),
    "moe_experts": (K.moe_experts,),
    "mamba2_scan": (K.mamba2_ssd,),
    "rwkv6_wkv": (K.wkv6,),
    "streamed_xent": (K.streamed_xent_parts, K.streamed_xent_loss),
}


def test_the_card_declarations_hold_against_the_wrappers():
    """A name declared not to reach the card is no parameter of the
    family's wrappers (``block_kv`` and ``chunk``, which are, are held by
    the fake-library test below); the declared names are the reference's
    lattice names, and the lattices are the reference's."""
    for impl, mod_name in _FAMILY_MODULES.items():
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        ref = importlib.import_module(f"repro.kernels.{mod_name}")
        assert mod.TUNE_SPACE == ref.TUNE_SPACE, impl
        assert set(mod.CARD_BLOCKS) == {"bfloat16", "float32"}
        for names in mod.CARD_BLOCKS.values():
            assert set(names) <= set(mod.TUNE_SPACE)
        hints = set(mod.TUNE_SPACE) - {n for v in mod.CARD_BLOCKS.values()
                                       for n in v}
        for fn in WRAPPERS[mod_name]:
            params = set(inspect.signature(fn).parameters)
            assert not (hints - {"block_kv", "chunk"}) & params, (
                fn.__name__)
            assert not {"block_m", "block_n", "block_t", "block_f",
                        "block_v", "block_q", "page_size"} & params


def test_the_plan_granules_read_the_declared_names():
    """``page_size`` and the attention ``block_q`` reach the card through
    the plan's granules: ``decode_page_size`` and ``prefill_chunk_size``
    move with them."""
    cfg, _ = _configs("llama3-8b", full=True)
    plan = build_stream_plan(cfg, tokens=4, kv_len=2048)
    lp = plan.layer("attn")
    for ps in (8, 16, 32, 64):
        got = plan.with_stage("attn", "decode_attn", KernelChoice(
            "paged_attention", (("page_size", ps),)))
        assert got.decode_page_size() == ps
    for bq in (128, 256, 512):
        got = plan.with_stage("attn", "attention", dataclasses.replace(
            lp.attention, blocks=(("block_q", bq), ("block_kv", 128))))
        assert got.prefill_chunk_size(64) == bq
        assert got.prefill_chunk_size(10) == -(-bq // 10) * 10


def _c_ints(args):
    """The launch's arguments other than pointers (CPU heap addresses)."""
    return tuple(a for a in args
                 if not (isinstance(a, int) and a > 2**40) and a is not None)


@pytest.fixture
def card_route(monkeypatch):
    """The CUDA route forced for CPU tensors, every library a
    ``_FakeLib``; returns the recorded launches."""
    calls = []
    mods = [importlib.import_module(f"repro_torch.kernels.{m}")
            for m in ("mamba2_scan", "rwkv6_wkv", "flash_attention")]
    for mod in mods:
        monkeypatch.setattr(mod, "kernel_path", lambda t: "cuda")
        mod._entry.cache_clear()
    for fn in (K.mamba2_ssd, K.wkv6, K.flash_attention_2d,
               K.flash_attention_static):
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(name, calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    yield calls
    for mod in mods:
        mod._entry.cache_clear()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_chunk_and_block_kv_reach_the_card_as_declared(card_route,
                                                           dtype):
    """Through a fake library: the SSD chunk changes the float32 launch's
    arguments and not the bf16 one's, the wkv chunk neither, ``block_kv``
    no flash launch's; as ``CARD_BLOCKS`` says."""
    calls = card_route
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    def launch(fn):
        calls.clear()
        fn()
        (lib, symbol, args), = calls
        return lib, symbol, _c_ints(args)

    b, s, h = 1, 256, 2
    x, dt = rand(b, s, h, 64), rand(b, s, h).abs()
    bc = [rand(b, s, 64) for _ in range(2)]
    a_log, d_skip = torch.zeros(h), torch.ones(h)
    ssd = [launch(lambda q=q: K.mamba2_ssd(x, dt, a_log, *bc, d_skip,
                                           chunk=q))
           for q in (32, 64, 128)]
    mod = importlib.import_module("repro_torch.kernels.mamba2_scan")
    assert (len(set(ssd)) > 1) == ("chunk" in mod.CARD_BLOCKS[name])
    r, k, v = rand(b, s, h, 64), rand(b, s, h, 64), rand(b, s, h, 64)
    w = torch.rand(b, s, h, 64, generator=gen)
    wkv = [launch(lambda q=q: K.wkv6(r, k, v, w, torch.zeros(h, 64),
                                     chunk=q)) for q in (16, 32, 64)]
    mod = importlib.import_module("repro_torch.kernels.rwkv6_wkv")
    assert (len(set(wkv)) > 1) == ("chunk" in mod.CARD_BLOCKS[name])
    q, kk, vv = rand(4, 37, 64), rand(2, 300, 64), rand(2, 300, 64)
    for kw in ({}, {"q_offset": 263}):
        flash = [launch(lambda bkv=bkv: K.flash_attention_2d(
            q, kk, vv, kv_group=2, block_kv=bkv, **kw))
            for bkv in (128, 256, 512)]
        assert len(set(flash)) == 1


# ---------------------------------------------------- specs and plumbing

def test_resolve_tuner_specs(tmp_path, monkeypatch):
    cfg, _ = _configs("gpt2")
    assert resolve_tuner(None, cfg, device="cpu") is None
    assert resolve_tuner(False, cfg, device="cpu") is None
    t = Tuner(device="cpu")
    assert resolve_tuner(t, cfg) is t
    tt = resolve_tuner(str(tmp_path / "x.json"), cfg, device="cpu")
    assert tt.table.path == str(tmp_path / "x.json")
    assert tt.device.type == "cpu" and tt.table.backend == CPU
    td = resolve_tuner(str(tmp_path), cfg, device="cpu")
    assert td.table.path == str(tmp_path / f"{cfg.name}.json")
    table = TuneTable(backend=CPU)
    assert resolve_tuner(table, cfg).table is table
    monkeypatch.setenv("REPRO_TORCH_TUNE_DIR", str(tmp_path / "dir"))
    assert resolve_tuner(True, cfg, device="cpu").table.path == str(
        tmp_path / "dir" / f"{cfg.name}.json")
    with pytest.raises(TypeError):
        resolve_tuner(123, cfg, device="cpu")


def test_use_tuner_reaches_plan_for():
    """``plan_for`` post-processes its cached plan through the active
    tuner outside the cache: an untuned caller still gets the untuned
    plan."""
    cfg, _ = _configs("gpt2")
    plan_for.cache_clear()
    tuner = Tuner(device="cpu")
    with use_tuner(tuner):
        plan = plan_for(cfg, 4, 64)
    assert tuner.stats.stages > 0
    assert plan == tuner.tune_plan(cfg, plan_for(cfg, 4, 64))
    assert plan_for(cfg, 4, 64) is not plan
    assert plan_for(cfg, 4, 64).decode_page_size() != plan.decode_page_size()
    with use_tuner(None):
        assert plan_for(cfg, 4, 64) is plan_for(cfg, 4, 64)


def test_build_stream_plan_takes_a_tune_table():
    cfg, _ = _configs("llama3-8b")
    table = TuneTable(backend=CPU)
    got = build_stream_plan(cfg, tokens=4, kv_len=1000, tune_table=table)
    want = build_stream_plan(cfg, tokens=4, kv_len=1000,
                             tune=Tuner(device="cpu"))
    assert got == want and len(table) > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tuned_registry_plans_verify_clean(arch):
    """A tuned plan passes the static verifier as strictly as the plan it
    came from, in every quant mode, for the CPU."""
    for quant in ("none", "kv_int8", "w8_kv8"):
        cfg, _ = _configs(arch, quant)
        plan = build_stream_plan(cfg, tokens=4, kv_len=64,
                                 tune=Tuner(device="cpu"))
        diags = verify_plan(plan, cfg, slots=2, max_len=64, device="cpu")
        assert clean(diags), (arch, quant, [str(d) for d in diags])


def test_verify_cli_tunes_on_its_device(capsys):
    """``python -m repro_torch.analysis.verify --tuned`` in-process: every
    plan tuned on ``--device`` verifies clean."""
    from repro_torch.analysis.verify import main
    assert main(["--device", "cpu", "--tuned", "--config",
                 "gpt2,llama3-8b,zamba2-2.7b"]) == 0
    out = capsys.readouterr().out
    assert out.count(" tuned ") == 9 and "all plans verified clean" in out


def _card_tuner():
    """A tuner for the card built without one (``Tuner()`` refuses this
    host): its lint and signature are the card's; only the paged stage,
    which the surrogate scores, may be tuned with it here."""
    from repro_torch.obs import NULL_RECORDER
    from repro_torch.tuning import TunerStats
    t = object.__new__(Tuner)
    t.table = TuneTable(backend="cuda:stand-in")
    t.mode, t.force_measure, t.autosave = "hybrid", False, False
    t.stats, t._memo, t.obs = TunerStats(), {}, NULL_RECORDER
    t.device = torch.device("cuda")
    return t


@pytest.mark.parametrize("arch,pages,pick", [
    ("llama3-8b", (8, 16), 16), ("gpt2", (8, 16, 32, 64), 64),
    ("qwen3-0.6b", (8, 16, 32), 32)])
def test_a_page_size_the_verify_kernel_refuses_is_pruned(arch, pages, pick):
    """On the card the verify kernel holds up to 64 window rows x query
    heads per KV head, and the lint counts the plan's widest window (a
    page): a decode page size whose verify block would exceed it is
    pruned with it, though the decode stage itself is clean (llama3's
    GQA 4 keeps 16-token pages; gpt2's MHA takes 64)."""
    from repro_torch.kernels.paged_attention import MAX_ROWS
    cfg, _ = _configs(arch, full=True)
    plan = build_stream_plan(cfg, tokens=4, kv_len=2048)
    tuner = _card_tuner()
    choice = plan.layer("attn").decode_attn
    best = tuner._tune_stage(cfg, plan, "attn", "decode_attn", choice, H100)
    legal = [c.block("page_size") for c in enumerate_candidates(
        cfg, plan, "decode_attn", choice, "cuda")
        if c.block("page_size") * cfg.num_heads // cfg.num_kv_heads
        <= MAX_ROWS]
    assert sorted(legal) == list(pages)
    assert best.block("page_size") == pick and best.source == "analytic"
    assert tuner.stats.pruned == 4 - len(pages)
