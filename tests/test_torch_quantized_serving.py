"""Quantized serving through the port's engine on the CPU, against the
JAX package (DESIGN.md §14): greedy tokens and metrics equal to the JAX
engine's under every quant mode (llama3 chunked, gpt2 chunked and
whole-prompt, kernel plan); speculative == plain and hot prefix == cold
under kv_int8, with the peak KV bytes at most 0.55x the unquantized
engine's; and the teacher-forced accuracy gate against the reference's.

Float32, on weights the JAX ``init_params`` draws (gpt2 jittered), bridged
with ``params_from_numpy``.  The primitives, kernels and model entry
points are held to the reference in ``test_torch_quantized.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.serving import ServingEngine as JServingEngine
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro.serving.accuracy import run_accuracy as j_run_accuracy
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.serving import ServingEngine
from repro_torch.serving.accuracy import run_accuracy

ARCHS = ("llama3-8b", "gpt2")


def _configs(arch: str, fused: bool, quant: str = "none"):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="float32", use_fused_kernels=fused,
                                quant=quant)
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                use_fused_kernels=fused, quant=quant)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def weights():
    """{arch: (jax params, port params)}; gpt2 jittered, or its
    zero-initialised LayerNorm scales make every logit zero."""
    out = {}
    for arch in ARCHS:
        j_cfg, t_cfg = _configs(arch, False)
        jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
        if arch == "gpt2":
            jp = j_jitter_params(jp)
        out[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           t_cfg, device="cpu"))
    return out


def _prompts(vocab: int):
    rng = np.random.default_rng(9)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in (12, 37, 5)]


@pytest.mark.parametrize("mode", ["kv_int8", "kv_fp8", "w8", "w8_kv8"])
def test_engine_greedy_tokens_equal_reference(weights, mode):
    """llama3 chunked, gpt2 chunked and whole-prompt, kernel plan."""
    for arch, chunked in (("llama3-8b", True), ("gpt2", True),
                          ("gpt2", False)):
        jp, tp = weights[arch]
        j_cfg, t_cfg = _configs(arch, True)
        prompts = _prompts(t_cfg.vocab_size)
        kw = dict(batch_slots=2, max_len=96, decode_block=4, chunked=chunked,
                  prefix_cache=False, quant=mode)
        ref = JServingEngine(j_cfg, jp, **kw)
        want = [r.out_tokens for r in ref.generate(
            [p.copy() for p in prompts], max_new_tokens=6)]
        eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
        got = eng.generate(prompts, max_new_tokens=6)
        assert [r.out_tokens for r in got] == want, (arch, chunked)
        m, jm = eng.metrics, ref.metrics
        assert m["quant"] == jm["quant"] == mode
        assert m["kv_itemsize_effective"] == pytest.approx(
            jm["kv_itemsize_effective"])
        assert m["kv_bytes_peak"] == jm["kv_bytes_peak"]
        eng.kv.assert_page_accounting(eng.cache)


def test_kv_int8_engine_exactness_and_bytes(weights):
    """Under kv_int8: speculative == plain (jittered gpt2 falls into short
    cycles, so n-gram drafts are accepted), a hot prefix == a cold one,
    and the peak KV bytes at most 0.55x the unquantized engine's."""
    _, tp = weights["gpt2"]
    _, t_cfg = _configs("gpt2", True)
    prompts = _prompts(t_cfg.vocab_size)
    kw = dict(batch_slots=2, max_len=96, decode_block=4, device="cpu")
    plain = ServingEngine(t_cfg, tp, prefix_cache=False, quant="kv_int8",
                          **kw)
    want = [r.out_tokens for r in plain.generate(prompts, max_new_tokens=8)]
    spec = ServingEngine(t_cfg, tp, speculative=True, quant="kv_int8", **kw)
    spec._debug_check_pages = True
    assert [r.out_tokens for r in spec.generate(
        prompts, max_new_tokens=8)] == want
    assert spec.metrics["accepted_tokens"] > 0
    spec.kv.assert_page_accounting(spec.cache)

    long = np.random.default_rng(10).integers(1, 250, 150).astype(np.int32)
    hot = ServingEngine(t_cfg, tp, quant="kv_int8",
                        **dict(kw, max_len=192))
    cold = hot.generate([long.copy()], max_new_tokens=8)[0].out_tokens
    again = hot.generate([long.copy()], max_new_tokens=8)[0].out_tokens
    assert again == cold and hot.metrics["prefix_hit_pages"] > 0
    hot.kv.assert_page_accounting(hot.cache)

    base = ServingEngine(t_cfg, tp, prefix_cache=False, **kw)
    base.generate(prompts, max_new_tokens=8)
    assert (plain.metrics["kv_bytes_peak"]
            <= 0.55 * base.metrics["kv_bytes_peak"])


# ---------------------------------------------- the accuracy gate

@pytest.mark.parametrize("arch", ARCHS)
def test_accuracy_gate_matches_reference(arch):
    """The port's teacher-forced gate on the reference's own weights gives
    its tokens_equal and max_logit_err within 1e-4; kv_int8 and w8_kv8
    keep the greedy stream and stay under 0.5 (the reference's gate)."""
    modes = ("kv_int8", "w8_kv8")
    want = j_run_accuracy(arch, modes=modes, steps=6)
    j_cfg, t_cfg = _configs(arch, False)
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(0), j_cfg), seed=0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg, device="cpu")
    got = run_accuracy(arch, modes=modes, steps=6, params=tp, device="cpu")
    assert got["none"]["tokens"] == want["none"]["tokens"]
    for mode in modes:
        assert got[mode]["tokens_equal"] == want[mode]["tokens_equal"]
        assert got[mode]["max_logit_err"] == pytest.approx(
            want[mode]["max_logit_err"], abs=1e-4)
        assert got[mode]["kv_itemsize"] == pytest.approx(
            want[mode]["kv_itemsize"])
    for mode in ("kv_int8", "w8_kv8"):
        assert got[mode]["tokens_equal"]
        assert got[mode]["max_logit_err"] < 0.5
