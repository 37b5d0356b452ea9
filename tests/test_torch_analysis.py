"""The port's static stream verifier (``repro_torch.analysis``) on the CPU,
mirroring ``tests/test_analysis.py`` and held to ``repro.analysis``.

* Seeded-bad fixtures: each broken plan, pool schema or dispatch
  signature gives the reference's (pass, stage, severity, code), with
  ``smem-exceeded`` in place of ``vmem-exceeded`` (an SSD chunk whose
  float32 block passes the H100's 227 KB).
* Registry sweep: every config x {none, kv_int8, w8_kv8} builds its H100
  plan and verifies clean, reduced on ``device="cpu"`` and full width on
  ``device="cuda"``; the reduced configs on ``"cuda"`` report their head
  dim 16 as ``unsupported-case``.
* ``stage_itensors`` and the itensor, effects and sharding diagnostics
  equal the reference's on the same plans; ``summary()`` records
  verification.
* ``smem_estimate`` equals hand-counted bytes: K2 at head dim 128, K4 at
  decode, K9c at head dim 320 (208,896).
* The engine hook: strict by default (the ``verified`` gauge equal to the
  JAX engine's), a bad mode refused, ``verify="off"`` and
  ``REPRO_VERIFY`` skip, a seeded error raises before anything is
  allocated.
"""

import copy
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import repro.analysis as JA
from repro.configs import get_config as j_get_config
from repro.core.platforms import TPU_V5E as J_TPU
from repro.core.stream_plan import KernelChoice as JKernelChoice
from repro.core.stream_plan import build_stream_plan as j_build_stream_plan
from repro.models.layers import DISPATCH_EFFECTS as J_EFFECTS
from repro_torch.analysis import (Diagnostic, PlanVerificationError, clean,
                                  errors, smem_estimate, stage_itensors,
                                  verify_plan)
from repro_torch.analysis.effects import check_effects
from repro_torch.analysis.kernel_lint import stage_kernels
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import TPU_V5E
from repro_torch.core.stream_plan import (KernelChoice, LayerPlan, StreamPlan,
                                          build_stream_plan)
from repro_torch.kernels.common import MAX_SMEM
from repro_torch.models.layers import DISPATCH_EFFECTS
from repro_torch.serving.kv_cache import paged_cache_defs

QUANTS = ("none", "kv_int8", "w8_kv8")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch="llama3-8b", full=False, **over):
    cfg = get_config(arch) if full else get_config(arch).reduced()
    over.setdefault("use_fused_kernels", True)
    return dataclasses.replace(cfg, **over)


def _j_cfg(arch="llama3-8b", **over):
    over.setdefault("use_fused_kernels", True)
    return dataclasses.replace(j_get_config(arch).reduced(), **over)


def _plan(cfg, tokens=4, kv_len=64, **kw):
    return build_stream_plan(cfg, tokens=tokens, kv_len=kv_len, **kw)


def _find(diags, code):
    return [d for d in diags if d.code == code]


def _keys(diags):
    return sorted((d.pass_name, d.stage, d.severity, d.code) for d in diags)


# ------------------------------------------------- seeded-bad fixtures

def test_bad_non_divisible_block():
    """An lm_head block_v that does not divide the vocabulary and is no
    whole number of 128-wide tiles is flagged, as by the reference."""
    cfg, j_cfg = _cfg(), _j_cfg()
    plan = _plan(cfg)
    bad = dataclasses.replace(plan, lm_head=KernelChoice(
        "streamed_xent", (("block_t", plan.tokens), ("block_v", 192))))
    diags = verify_plan(bad, cfg, device="cpu")
    hits = _find(diags, "non-divisible-block")
    assert hits, [str(d) for d in diags]
    d = hits[0]
    assert d.severity == "warning" and d.pass_name == "kernel"
    assert d.stage == "final.lm_head"
    assert "192" in d.message and d.fix_hint
    j_plan = j_build_stream_plan(j_cfg, tokens=4, kv_len=64)
    j_bad = dataclasses.replace(j_plan, lm_head=JKernelChoice(
        "streamed_xent", (("block_t", 4), ("block_v", 192))))
    assert _keys(diags) == _keys(JA.verify_plan(j_bad, j_cfg))


def test_bad_over_smem_tile():
    """An SSD chunk whose float32 block needs more than an H100 block's
    227 KB of shared memory is a hard error (the reference's
    vmem-exceeded): the hand-built plan is never launched."""
    cfg = _cfg("zamba2-2.7b", full=True, dtype="float32")
    lp = LayerPlan(kind="mamba",
                   mixer=KernelChoice("mamba2_scan", (("chunk", 256),)))
    plan = StreamPlan(
        arch=cfg.name, tokens=4096, kv_len=4096, platform="NVIDIA-H100",
        default_tile_size=128, overall_unroll_size=64,
        layers=(("mamba", lp),), quant=cfg.quant)
    diags = verify_plan(plan, cfg, device="cpu")
    hits = _find(diags, "smem-exceeded")
    assert hits, [str(d) for d in diags]
    d = hits[0]
    assert d.severity == "error" and d.pass_name == "kernel"
    assert d.stage == "mamba.mixer" and "mamba2_ssd_kernel" in d.message
    assert smem_estimate(cfg, plan, "mixer", lp.mixer) > MAX_SMEM
    # The wrapper refuses the launch with the same bytes.
    from repro_torch.kernels.mamba2_scan import cuda_refusal
    assert str(smem_estimate(cfg, plan, "mixer", lp.mixer)) in cuda_refusal(
        256, cfg.ssm_head_dim, cfg.ssm_state, torch.float32)
    # The compiler's own chunk fits.
    good = dataclasses.replace(plan, layers=(("mamba", LayerPlan(
        kind="mamba",
        mixer=KernelChoice("mamba2_scan", (("chunk", 128),)))),))
    assert not _find(verify_plan(good, cfg, device="cpu"), "smem-exceeded")


def test_bad_mismatched_psum_axes():
    """Column-parallel qkv reducing over 'model' while the row-parallel
    FFN psums over 'data' is a coherence error, as in the reference."""
    cfg = _cfg(full=True)
    lp = LayerPlan(
        kind="attn",
        qkv=KernelChoice("rmsnorm_matmul",
                         (("block_t", 128), ("block_n", 128)),
                         (("tokens", "data"), ("out", "model"))),
        ffn=KernelChoice("streamed_ffn",
                         (("block_t", 128), ("block_f", 128)),
                         (("d_ff", "data"),)))
    plan = StreamPlan(
        arch=cfg.name, tokens=256, kv_len=256, platform="NVIDIA-H100",
        default_tile_size=128, overall_unroll_size=64,
        layers=(("attn", lp),), quant=cfg.quant,
        mesh_axes=(("data", 2), ("model", 4)))
    diags = verify_plan(plan, cfg, device="cpu")
    hits = _find(diags, "psum-mismatch")
    assert hits, [str(d) for d in diags]
    d = hits[0]
    assert d.severity == "error" and d.pass_name == "sharding"
    assert d.stage == "attn.ffn"
    assert "'model'" in d.message and "'data'" in d.message


def test_bad_missing_scale_pool():
    """A quantized pool schema missing a _scale sibling."""
    cfg = _cfg(quant="kv_int8")
    plan = _plan(cfg)
    defs = paged_cache_defs(cfg, 2, 64, 16)
    victim = next(n for n in defs if n.endswith("_scale"))
    del defs[victim]
    diags = check_effects(plan, cfg, page_size=16, cache_defs=defs)
    hits = _find(diags, "missing-scale-pool")
    assert hits
    d = hits[0]
    assert d.severity == "error" and d.pass_name == "effects"
    assert d.stage == f"pool.{victim[:-len('_scale')]}"
    # The intact schema verifies clean.
    good = paged_cache_defs(cfg, 2, 64, 16)
    assert not errors(check_effects(plan, cfg, page_size=16,
                                    cache_defs=good))
    # A scale pool of the wrong dtype or shape.
    doctored = dict(good)
    sd = doctored[victim]
    doctored[victim] = dataclasses.replace(sd, dtype=torch.bfloat16)
    assert _find(check_effects(plan, cfg, page_size=16,
                               cache_defs=doctored), "scale-dtype")
    doctored[victim] = dataclasses.replace(sd, shape=sd.shape[:-1] + (99,))
    assert _find(check_effects(plan, cfg, page_size=16,
                               cache_defs=doctored), "scale-shape")
    # Pools of another page granule than the plan streams.
    assert _find(check_effects(plan, cfg, page_size=8, cache_defs=good),
                 "page-granule-mismatch")


def test_bad_cow_self_alias():
    """A decode signature whose copy-on-write step loses the fresh-dst
    allocator guarantee."""
    cfg = _cfg()
    plan = _plan(cfg)
    sigs = copy.deepcopy(DISPATCH_EFFECTS)
    sigs["decode"]["ops"][0]["cow"]["fresh_dst"] = False
    diags = check_effects(plan, cfg, signatures=sigs)
    hits = _find(diags, "cow-self-alias")
    assert hits
    d = hits[0]
    assert d.severity == "error" and d.pass_name == "effects"
    assert d.stage == "dispatch.decode"
    # The shipped signatures carry no such bug.
    assert not errors(check_effects(plan, cfg))


def test_bad_donated_read_after_write():
    """Reordering a dispatch's ops so the initial-contents read follows
    an in-place write to the buffer is rejected."""
    cfg = _cfg()
    plan = _plan(cfg)
    sigs = copy.deepcopy(DISPATCH_EFFECTS)
    sigs["decode"]["ops"] = tuple(reversed(sigs["decode"]["ops"]))
    diags = check_effects(plan, cfg, signatures=sigs)
    hits = _find(diags, "donated-read-after-write")
    assert hits and hits[0].severity == "error"
    assert hits[0].stage == "dispatch.decode"


def test_bad_scale_lockstep_and_null_routing():
    """Dropping updates_scales (under KV quant) or null_routed from a
    page-indexed write is rejected."""
    cfg = _cfg(quant="kv_int8")
    plan = _plan(cfg)
    sigs = copy.deepcopy(DISPATCH_EFFECTS)
    op = dict(sigs["prefill"]["ops"][1])
    op["updates_scales"] = False
    op["null_routed"] = False
    sigs["prefill"]["ops"] = (sigs["prefill"]["ops"][0], op)
    diags = check_effects(plan, cfg, signatures=sigs)
    assert _find(diags, "scale-lockstep")
    assert _find(diags, "unguarded-null-page")
    assert all(d.stage == "dispatch.prefill" for d in errors(diags))


def test_bad_quant_mismatch_and_unknown_kernel():
    cfg = _cfg(quant="kv_int8")
    plan = _plan(_cfg(quant="none"))           # plan from the wrong mode
    diags = verify_plan(plan, cfg, device="cpu")
    assert any(d.code in ("quant-mismatch", "prefetch-arity")
               and d.severity == "error" for d in diags)
    # The reference's errors, and the offset entry point's scale operands
    # beside them (the port's K9c takes them as pointers).
    j_cfg = _j_cfg(quant="kv_int8")
    j_plan = j_build_stream_plan(_j_cfg(quant="none"), tokens=4, kv_len=64)
    want = _keys(errors(JA.verify_plan(j_plan, j_cfg)))
    got = _keys(errors(diags))
    assert set(want) <= set(got)
    assert set(got) - set(want) == {
        ("kernel", "attn.attention", "error", "prefetch-arity")}
    bad = dataclasses.replace(
        plan, lm_head=KernelChoice("warp_gemm", (("block_t", 4),)))
    hits = _find(verify_plan(bad, _cfg(quant="none"), device="cpu"),
                 "unknown-kernel")
    assert hits and hits[0].severity == "error"
    # w8 on a config without weight quantization, a page size of 0.
    lp = plan.layer("attn")
    w8 = plan.with_stage("attn", "qkv", KernelChoice(
        "rmsnorm_matmul", lp.qkv.blocks + (("w8", 1),)))
    assert _find(verify_plan(w8, _cfg(quant="none"), device="cpu"),
                 "w8-without-weight-quant")
    zero = plan.with_stage("attn", "decode_attn", KernelChoice(
        "paged_attention", (("page_size", 0),)))
    assert _find(verify_plan(zero, _cfg(quant="none"), device="cpu"),
                 "bad-page-size")


def test_mesh_mismatch():
    """A plan recorded for one mesh verified against another is an error
    (the port builds no mesh: the plan carries the axes by hand)."""
    cfg = _cfg()
    plan = dataclasses.replace(_plan(cfg),
                               mesh_axes=(("data", 2), ("model", 4)))
    other = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": 4, "model": 2})
    hits = _find(verify_plan(plan, cfg, mesh=other, device="cpu"),
                 "mesh-mismatch")
    assert hits and hits[0].severity == "error"
    same = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 2, "model": 4})
    assert not _find(verify_plan(plan, cfg, mesh=same, device="cpu"),
                     "mesh-mismatch")
    with pytest.raises(ValueError, match="device"):
        verify_plan(plan, cfg, device="tpu")


# ------------------------------------------------------- registry sweep

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_registry_verifies_clean_on_the_cpu(arch):
    """Every config x quant mode, reduced, verifies clean where the plain
    versions run it; on the card its head dim 16 is refused."""
    for quant in QUANTS:
        cfg = _cfg(arch, quant=quant)
        plan = _plan(cfg)
        diags = verify_plan(plan, cfg, slots=2, max_len=64, device="cpu")
        assert clean(diags), (
            f"{arch}/{quant}: "
            + "; ".join(str(d) for d in diags if d.severity != "info"))
        assert plan.with_verification(True, ()).verified is True
        if not cfg.rwkv:           # attention at head dim 16
            cuda = verify_plan(plan, cfg, slots=2, max_len=64,
                               device="cuda")
            assert _find(cuda, "unsupported-case")
            assert {d.code for d in errors(cuda)} == {"unsupported-case"}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_registry_verifies_clean_on_the_card(arch):
    """Every config x quant mode at full width verifies clean for the
    card at serving shapes (4 slots over 1000 and 4096 positions) and a
    prefill chunk's 130 rows."""
    for quant in QUANTS:
        cfg = _cfg(arch, full=True, quant=quant)
        for tokens, kv_len in ((4, 1000), (4, 4096), (130, 1000)):
            plan = _plan(cfg, tokens=tokens, kv_len=kv_len)
            diags = verify_plan(plan, cfg, slots=4, max_len=kv_len,
                                device="cuda")
            assert clean(diags), (
                f"{arch}/{quant}/{tokens}x{kv_len}: "
                + "; ".join(str(d) for d in diags if d.severity != "info"))


# ---------------------------------- the passes against the reference

@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2", "zamba2-2.7b",
                                  "granite-moe-1b-a400m", "rwkv6-7b"])
def test_passes_equal_reference_on_the_same_plans(arch):
    """On the reference's TPU plans (the port's equal them), the
    reconstructed itensors and the itensor, effects and sharding
    diagnostics equal ``repro.analysis``'s."""
    from repro.analysis.effects import check_effects as j_check_effects
    from repro.analysis.itensor_check import check_itensors as j_itensors
    from repro.analysis.sharding_check import check_sharding as j_sharding
    from repro_torch.analysis.itensor_check import check_itensors
    from repro_torch.analysis.sharding_check import check_sharding

    def full(d):
        return (d.severity, d.pass_name, d.stage, d.code, d.message,
                d.fix_hint)

    for quant, (tokens, kv_len) in (("none", (8, 64)),
                                    ("kv_int8", (128, 256))):
        cfg, j_cfg = _cfg(arch, quant=quant), _j_cfg(arch, quant=quant)
        plan = build_stream_plan(cfg, tokens=tokens, kv_len=kv_len,
                                 platform=TPU_V5E)
        j_plan = j_build_stream_plan(j_cfg, tokens=tokens, kv_len=kv_len,
                                     platform=J_TPU)
        mine, ref = stage_itensors(plan, cfg), JA.stage_itensors(j_plan,
                                                                j_cfg)
        assert list(mine) == list(ref)
        for key, it in mine.items():
            r = ref[key]
            assert (it.elem_shape, it.tripcounts, it.steps, it.dtype,
                    str(it.iter_map)) == (
                r.elem_shape, r.tripcounts, r.steps, r.dtype,
                str(r.iter_map)), key
        budget = TPU_V5E.fusion_budget(0.5)
        assert ([full(d) for d in check_itensors(plan, cfg, budget)]
                == [full(d) for d in j_itensors(j_plan, j_cfg, budget)])
        assert ([full(d) for d in check_effects(plan, cfg)]
                == [full(d) for d in j_check_effects(j_plan, j_cfg)])
        sigs, j_sigs = copy.deepcopy(DISPATCH_EFFECTS), copy.deepcopy(
            J_EFFECTS)
        for s in (sigs, j_sigs):
            s["verify"]["ops"] = tuple(reversed(s["verify"]["ops"]))
            s["decode"]["ops"][0]["cow"]["fresh_dst"] = False
        assert ([full(d) for d in check_effects(plan, cfg, signatures=sigs)]
                == [full(d) for d in j_check_effects(j_plan, j_cfg,
                                                     signatures=j_sigs)])
        # Sharding claims by hand on both plans' qkv and ffn stages.
        claims = {"qkv": (("tokens", "data"), ("out", "model")),
                  "ffn": (("tokens", "data"), ("d_ff", "model")),
                  "attention": (("batch", "data"),)}
        axes = {"data": 3, "model": 4}

        def claimed(p):
            for kind, lp in p.layers:
                for stage, sh in claims.items():
                    c = getattr(lp, stage)
                    if c.fused:
                        p = p.with_stage(kind, stage,
                                         dataclasses.replace(c, sharding=sh))
            return p
        assert ([full(d) for d in check_sharding(claimed(plan), cfg, axes)]
                == [full(d) for d in j_sharding(claimed(j_plan), j_cfg,
                                                axes)])


def test_plan_summary_records_verification():
    cfg = _cfg()
    plan = _plan(cfg)
    assert plan.summary()["verified"] is None
    v = plan.with_verification(True, ("[info] x",))
    s = v.summary()
    assert s["verified"] is True and s["diagnostics"] == ["[info] x"]


def test_diagnostic_validation():
    with pytest.raises(ValueError):
        Diagnostic("fatal", "kernel", "x", "c", "m")
    with pytest.raises(ValueError):
        Diagnostic("error", "vibes", "x", "c", "m")
    d = Diagnostic("error", "kernel", "attn.ffn", "code", "msg", "hint")
    assert "kernel:code" in str(d) and "fix: hint" in str(d)
    err = PlanVerificationError([d])
    assert d in err.diagnostics and "1 error" in str(err)


# ------------------------------------------------- shared memory by hand

def test_smem_estimate_hand_counted():
    """K2 (llama3, D 128): the Q tile and two stages of K and V tiles,
    64 rows each at a stride of 136 bf16.  K4 (llama3, 4 rows, the fused
    launch): 5 ring stages of the x tile (16 x 72) and the Wg / Wu tiles
    (2 x 64 x 136), the h slice 16 x 136, 128 static bytes (the rstd rows
    and the arrival flag, rounded to the ring's 128).  K9c (gemma3, D 320,
    int8 codes, one key group): Q and the converted K and V tiles (192 x
    328 bf16), two stages of the codes (4 x 64 x 320) and their scales (4
    x 64 floats)."""
    llama = _cfg("llama3-8b", full=True)
    plan = _plan(llama, tokens=4, kv_len=1000)
    lp = plan.layer("attn")
    assert smem_estimate(llama, plan, "attention", lp.attention) == (
        (64 + 4 * 64) * 136 * 2) == 87_040
    assert smem_estimate(llama, plan, "ffn", lp.ffn) == (
        5 * (16 * 72 * 2 + 2 * 64 * 136 * 2) + 16 * 136 * 2 + 128) == 190_080
    gemma = _cfg("gemma3-4b", full=True, quant="kv_int8")
    plan = _plan(gemma, tokens=130, kv_len=1000)
    att = plan.layer("local_attn").attention
    kernels = stage_kernels(gemma, plan, "attention", att)
    k9c = (64 + 2 * 64) * 328 * 2 + 4 * 64 * 320 + 4 * 64 * 4
    assert k9c == 208_896
    assert kernels["flash_mma_q_kernel<320, signed char>"] == k9c
    assert kernels["flash_mma_kernel<320>"] == 320 * 328 * 2
    assert smem_estimate(gemma, plan, "attention", att) == max(
        kernels.values()) <= MAX_SMEM


# ---------------------------------------------------------- engine hook

@pytest.fixture(scope="module")
def qwen_params():
    from repro.models import init_params as j_init_params
    from repro_torch.models.params import params_from_numpy
    j_cfg = _j_cfg("qwen1.5-0.5b")
    jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
    cfg = _cfg("qwen1.5-0.5b")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, tp, j_cfg, jp


def test_engine_verify_strict_default(qwen_params, monkeypatch):
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.serving import ServingEngine
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    cfg, tp, j_cfg, jp = qwen_params
    eng = ServingEngine(cfg, tp, batch_slots=2, max_len=64, device="cpu")
    assert eng.verify_mode == "strict"
    assert eng.plan is not None and eng.plan.verified is True
    assert eng.metrics["verified"] == 1
    assert eng.plan.summary()["verified"] is True
    assert eng.metrics["plan_source"] == eng.plan.cost_source == "analytic"
    ref = JServingEngine(j_cfg, jp, batch_slots=2, max_len=64)
    assert ref.verify_mode == "strict"
    assert eng.metrics["verified"] == ref.metrics["verified"]


def test_engine_verify_rejects_bad_mode(qwen_params):
    from repro_torch.serving import ServingEngine
    cfg, tp, _, _ = qwen_params
    with pytest.raises(ValueError, match="verify mode"):
        ServingEngine(cfg, tp, batch_slots=2, max_len=64, device="cpu",
                      verify="paranoid")


def test_engine_verify_off_skips(qwen_params, monkeypatch):
    from repro_torch.serving import ServingEngine
    cfg, tp, _, _ = qwen_params
    eng = ServingEngine(cfg, tp, batch_slots=2, max_len=64, device="cpu",
                        verify="off")
    assert eng.plan.verified is None and eng.metrics["verified"] == 0
    monkeypatch.setenv("REPRO_VERIFY", "off")
    eng = ServingEngine(cfg, tp, batch_slots=2, max_len=64, device="cpu")
    assert eng.verify_mode == "off" and eng.plan.verified is None


def test_engine_refuses_a_seeded_plan_before_allocating(qwen_params,
                                                        monkeypatch):
    """A plan with an error raises before the pools (or the quantized
    weights) exist; "warn" records it and goes on; "off" lets it
    through."""
    import repro_torch.serving.engine as E
    cfg, tp, _, _ = qwen_params
    good = build_stream_plan(cfg, tokens=2, kv_len=64)
    bad = good.with_stage("attn", "decode_attn", KernelChoice(
        "paged_attention", (("page_size", 0),)))
    monkeypatch.setattr(E, "resolve_plan", lambda *a, **k: bad)
    made = []

    def forbidden(*a, **k):
        made.append(a)
        raise AssertionError("allocated before verification")
    monkeypatch.setattr(E, "PagedKVCache", forbidden)
    monkeypatch.setattr(E, "quantize_weights", forbidden)
    with pytest.raises(PlanVerificationError) as e:
        E.ServingEngine(cfg, tp, batch_slots=2, max_len=64, device="cpu",
                        page_size=16)
    assert made == [] and _find(e.value.diagnostics, "bad-page-size")
    monkeypatch.undo()
    monkeypatch.setattr(E, "resolve_plan", lambda *a, **k: bad)
    with pytest.warns(UserWarning, match="static verification"):
        eng = E.ServingEngine(cfg, tp, batch_slots=2, max_len=64,
                              device="cpu", page_size=16, verify="warn")
    assert eng.plan.verified is False and eng.metrics["verified"] == 0
    eng = E.ServingEngine(cfg, tp, batch_slots=2, max_len=64, device="cpu",
                          page_size=16, verify="off")
    assert eng.plan.verified is None


def test_engine_verifies_for_its_device(qwen_params, monkeypatch):
    """The hook passes the engine's device: the reduced config's head dim
    16 runs on the CPU, and the same plan is refused for the card."""
    import repro_torch.serving.engine as E
    cfg, tp, _, _ = qwen_params
    seen = []
    real = E.verify_plan
    monkeypatch.setattr(E, "verify_plan",
                        lambda *a, **k: seen.append(k["device"])
                        or real(*a, **k))
    eng = E.ServingEngine(cfg, tp, batch_slots=2, max_len=64, device="cpu")
    assert seen == ["cpu"]
    assert errors(verify_plan(eng.plan, cfg, slots=2, max_len=64,
                              device="cuda"))
