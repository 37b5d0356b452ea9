"""The port's StreamPlan compiler (``core/stream_plan.py``) against the
reference's, on the CPU.

* ``build_stream_plan`` equals ``repro.core.stream_plan.build_stream_plan``
  field for field (layers, LM head, tile, unroll, fusion groups,
  implementations, quant, shape; the modeled latency at relative 1e-9) on
  the reference's four platforms and on ``H100``, where the oracle is the
  reference compiler on a ``repro.core.platforms.Platform`` built from
  ``H100``'s fields.  Every registry config, reduced and full width,
  under ``none`` and ``w8_kv8``, at token counts 1..4096 with and without
  a KV length (a sample: each config a few shapes on ``H100``, one on
  each of the other platforms).
* ``plan_for`` is that build on ``H100``, cached; None for an eager
  config; ``mesh=`` raises, naming the ROADMAP item; ``tune=`` and
  ``tune_table=`` tune the plan (``tests/test_torch_tuning.py`` holds the
  tuned plans to the reference's).
* ``H100``: its constants, its tiers under ``compile_model``, and the
  ``StreamPlan`` methods (``summary``, ``stage_choices``, ``with_stage``,
  ``with_verification``) as the reference's.

``j_plan_for`` here is the reference compiler aimed at the same card:
the port's ``plan_for`` tests in the other files import it.
"""

import dataclasses
import functools
import math

import pytest
import torch

import repro.core.platforms as J_platforms
from repro.configs import get_config as j_get_config
from repro.core.stream_plan import build_stream_plan as j_build_stream_plan
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import H100, PLATFORMS, compile_model
from repro_torch.core.allocation import H100_TIERS
from repro_torch.core.stream_plan import (STAGES, KernelChoice,
                                          build_stream_plan, plan_for)

# The reference's Platform with H100's constants: the reference compiler
# aimed at the card the port targets.
J_H100 = J_platforms.Platform(**{f.name: getattr(H100, f.name)
                                 for f in dataclasses.fields(H100)})
J_PLATFORMS = {"u55c": J_platforms.U55C, "a100": J_platforms.A100,
               "2080ti": J_platforms.RTX2080TI,
               "tpu_v5e": J_platforms.TPU_V5E, "h100": J_H100}


@functools.lru_cache(maxsize=256)
def j_plan_for(j_cfg, tokens, kv_len=None):
    """The reference's ``build_stream_plan`` on ``H100``'s constants (what
    the port's ``plan_for`` must return), cached as ``plan_for`` is."""
    return j_build_stream_plan(j_cfg, tokens=tokens, kv_len=kv_len,
                               platform=J_H100)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, reduced, quant):
    base, j_base = get_config(arch), j_get_config(arch)
    if reduced:
        base, j_base = base.reduced(), j_base.reduced()
    over = dict(use_fused_kernels=True, quant=quant)
    return (dataclasses.replace(base, **over),
            dataclasses.replace(j_base, **over))


def _choice(c):
    return (c.implementation, tuple(c.blocks), tuple(c.sharding), c.source)


def _fields(plan):
    """Every plan field but the modeled latency, as plain values."""
    return dict(
        arch=plan.arch, tokens=plan.tokens, kv_len=plan.kv_len,
        platform=plan.platform, tile=plan.default_tile_size,
        unroll=plan.overall_unroll_size, quant=plan.quant,
        layers=tuple((kind, tuple((s, _choice(getattr(lp, s)))
                                  for s in STAGES))
                     for kind, lp in plan.layers),
        lm_head=_choice(plan.lm_head), fusion_groups=plan.fusion_groups,
        implementations=tuple(plan.implementations),
        mesh_axes=tuple(plan.mesh_axes), verified=plan.verified,
        diagnostics=tuple(plan.diagnostics), cost_source=plan.cost_source)


def assert_same_plan(mine, ref):
    assert _fields(mine) == _fields(ref)
    assert math.isclose(mine.modeled_latency_s, ref.modeled_latency_s,
                        rel_tol=1e-9)


# Shapes: (tokens, kv_len); None is a training step's (no KV length).
SHAPES = ((1, None), (4, 1000), (128, 2048), (4096, None), (20, 300),
          (2048, 4096), (64, None), (4, 4096))
VARIANTS = [(r, q) for r in (True, False) for q in ("none", "w8_kv8")]


@pytest.mark.parametrize("variant", VARIANTS,
                         ids=[f"{'reduced' if r else 'full'}-{q}"
                              for r, q in VARIANTS])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_build_stream_plan_equals_reference_on_h100(arch, variant):
    reduced, quant = variant
    cfg, j_cfg = _configs(arch, reduced, quant)
    # Two shapes per case, rotating through SHAPES across the cases.
    i = (sorted(ARCHS).index(arch) * 2 + VARIANTS.index(variant) * 3)
    for tokens, kv_len in (SHAPES[i % len(SHAPES)],
                           SHAPES[(i + 5) % len(SHAPES)]):
        mine = build_stream_plan(cfg, tokens=tokens, kv_len=kv_len)
        assert mine.platform == "NVIDIA-H100"
        assert_same_plan(mine, j_plan_for(j_cfg, tokens, kv_len))


@pytest.mark.parametrize("platform", ["u55c", "a100", "2080ti", "tpu_v5e"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_build_stream_plan_equals_reference_on_its_platforms(arch,
                                                             platform):
    k = sorted(ARCHS).index(arch) + ["u55c", "a100", "2080ti",
                                     "tpu_v5e"].index(platform)
    reduced, quant = VARIANTS[k % len(VARIANTS)]
    tokens, kv_len = SHAPES[k % len(SHAPES)]
    cfg, j_cfg = _configs(arch, reduced, quant)
    mine = build_stream_plan(cfg, tokens=tokens, kv_len=kv_len,
                             platform=PLATFORMS[platform])
    ref = j_build_stream_plan(j_cfg, tokens=tokens, kv_len=kv_len,
                              platform=J_PLATFORMS[platform])
    assert_same_plan(mine, ref)


def test_cost_source_reaches_the_dse():
    """``cost_source=`` goes to ``compile_model``'s DSE, as in the
    reference: a measured source that scores every kernel at 1 ms moves
    the modeled latency, on both sides alike."""
    from repro.core.dse import CostSource as JCostSource

    from repro_torch.core.dse import CostSource
    cfg, j_cfg = _configs("llama3-8b", True, "none")
    src = CostSource(mode="measured", lookup=lambda name: 1e-3)
    j_src = JCostSource(mode="measured", lookup=lambda name: 1e-3)
    mine = build_stream_plan(cfg, tokens=64, kv_len=256, cost_source=src)
    ref = j_build_stream_plan(j_cfg, tokens=64, kv_len=256,
                              platform=J_H100, cost_source=j_src)
    assert_same_plan(mine, ref)
    analytic = build_stream_plan(cfg, tokens=64, kv_len=256)
    assert mine.modeled_latency_s != analytic.modeled_latency_s


def test_plan_for_is_the_cached_h100_build():
    cfg, _ = _configs("gpt2", True, "none")
    plan_for.cache_clear()
    first = plan_for(cfg, 4, 1000)
    assert first is plan_for(cfg, 4, 1000)
    assert plan_for.cache_info().hits >= 1
    assert _fields(first) == _fields(build_stream_plan(
        cfg, tokens=4, kv_len=1000, platform=H100))
    assert plan_for(dataclasses.replace(cfg, use_fused_kernels=False),
                    4, 1000) is None


def test_unported_arguments_raise():
    cfg, _ = _configs("llama3-8b", True, "none")
    with pytest.raises(NotImplementedError, match="item 10"):
        build_stream_plan(cfg, tokens=4, mesh=object())


def test_tune_tunes_the_plan():
    """``tune=`` (a CPU tuner here) rewrites the plan's granules: the
    paged stages move to the surrogate's 64-token pages; ``tune=False``
    and ``tune=None`` leave the plan as built."""
    from repro_torch.tuning import Tuner
    cfg, _ = _configs("llama3-8b", True, "none")
    base = build_stream_plan(cfg, tokens=4, kv_len=1000)
    for off in (None, False):
        assert build_stream_plan(cfg, tokens=4, kv_len=1000,
                                 tune=off) == base
    tuner = Tuner(device="cpu")
    tuned = build_stream_plan(cfg, tokens=4, kv_len=1000, tune=tuner)
    assert tuner.stats.stages > 0 and tuned != base
    assert base.decode_page_size() == 10 and tuned.decode_page_size() == 64


def test_tune_table_tunes_the_plan(tmp_path):
    """``tune_table=`` takes an ``autotune=`` spec: a CPU table is scored
    and written through."""
    from repro_torch.tuning import TuneTable, backend_fingerprint
    cfg, _ = _configs("gpt2", True, "none")
    table = TuneTable(path=str(tmp_path / "t.json"),
                      backend=backend_fingerprint("cpu"))
    tuned = build_stream_plan(cfg, tokens=4, kv_len=1000, tune_table=table)
    assert len(table) > 0 and (tmp_path / "t.json").exists()
    assert tuned.decode_page_size() == 64


def test_h100_platform_and_tiers():
    assert PLATFORMS["h100"] is H100
    assert (H100.name, H100.peak_flops, H100.peak_int8_ops, H100.hbm_bw,
            H100.link_bw, H100.onchip_bytes, H100.smem_bytes,
            H100.thermal_power_w, H100.freq_hz) == (
        "NVIDIA-H100", 989e12, 1979e12, 3.35e12, 50e9, 50 * 2**20, 232_448,
        700.0, 1.98e9)
    assert H100.dma_ports == 132 and H100.compute_lanes == 2048
    assert [t.name for t in H100_TIERS] == ["SMEM", "L2", "HBM"]
    cfg, _ = _configs("llama3-8b", True, "none")
    c = compile_model(cfg, tokens=32, platform=H100, dse_budget=2)
    assert set(c.allocation.tier_used) == {"SMEM", "L2", "HBM"}
    tpu = compile_model(cfg, tokens=32, dse_budget=2)
    assert set(tpu.allocation.tier_used) == {"SMEM", "VMEM", "HBM"}


def test_plan_methods_equal_reference():
    cfg, j_cfg = _configs("zamba2-2.7b", True, "w8_kv8")
    mine = build_stream_plan(cfg, tokens=64, kv_len=512)
    ref = j_plan_for(j_cfg, 64, 512)
    assert mine.summary() == ref.summary()
    assert ([(o, s, _choice(c)) for o, s, c in mine.stage_choices()]
            == [(o, s, _choice(c)) for o, s, c in ref.stage_choices()])
    assert all(lp.any_fused for _, lp in mine.layers)
    new = KernelChoice("streamed_xent", (("block_t", 64),))
    assert mine.with_stage("final", "lm_head", new).lm_head == new
    swapped = mine.with_stage("mamba", "mixer", new)
    assert swapped.layer("mamba").mixer == new
    assert swapped.layer("mamba+shared_attn") == mine.layer(
        "mamba+shared_attn")
    with pytest.raises(ValueError):
        mine.with_stage("mamba", "router", new)
    with pytest.raises(ValueError):
        mine.with_stage("attn", "qkv", new)
    v = mine.with_verification(False, ("[error] x",))
    assert (v.verified, v.diagnostics) == (False, ("[error] x",))
    assert v.summary()["verified"] is False
