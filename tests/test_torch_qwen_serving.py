"""The port's engine serving the Qwen decoders on the CPU, against
``repro.serving.ServingEngine``.

The three configs reduced, float32, the same jittered weights (the JAX
``init_params`` and ``jitter_params`` through the numpy bridge) and the
same mixed-length burst.  The port's greedy tokens and counters must equal
the JAX engine's:

* qwen3-0.6b and qwen1.5-0.5b: chunked with the prefix cache (on by
  default) on the kernel and eager plans and speculative verify (also
  equal to the port's plain engine); qwen3 also whole-prompt and under
  ``w8_kv8``;
* qwen2-vl-2b (M-RoPE): whole-prompt admission on both plans and under
  ``w8_kv8``; the engine refuses chunked prefill, the prefix cache and
  speculative verify for it, as the reference does.

The accuracy gate: qwen3's report equals the reference's;
qwen2-vl's, which the reference cannot score (its gate prefills through
``prefill_chunk``), prefills whole and reads the JAX engine's greedy
tokens as its unquantized stream.  On the CPU the kernel plan runs each
kernel's plain version.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.serving import ServingEngine as JServingEngine
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro.serving.accuracy import run_accuracy as j_run_accuracy
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.serving import ServingEngine
from repro_torch.serving.accuracy import run_accuracy

ARCHS = ("qwen3-0.6b", "qwen1.5-0.5b", "qwen2-vl-2b")
VLM = "qwen2-vl-2b"
BURST = (5, 150, 37, 90, 17)
COUNTERS = ("prefix_hit_pages", "prompt_pages", "draft_tokens",
            "accepted_tokens", "spec_tokens", "verify_dispatches",
            "rollbacks", "generated", "prefills", "prefill_chunks")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU runs here are many small ops: one intra-op thread
    each (restored after the module), so that the test workers running
    beside one another do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch: str, fused: bool):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                use_fused_kernels=fused)
    return j_cfg, t_cfg


def _weights(arch: str):
    j_cfg, t_cfg = _configs(arch, False)
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(0), j_cfg), seed=0)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                                 device="cpu")


@pytest.fixture(scope="module")
def weights():
    return {arch: _weights(arch) for arch in ARCHS}


def _burst(vocab: int):
    """The mixed burst, plus a repeat of the 150-token prompt (a prefix
    hit past the 128-token chunk) and a periodic prompt (n-gram drafts)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in BURST]
    return prompts + [prompts[1].copy(),
                      np.array([1, 2, 3, 4, 5, 6, 7, 8] * 5, np.int32)]


ENGINES = {
    "chunked": dict(chunked=True),
    "whole_prompt": dict(chunked=False, prefix_cache=False),
    "speculative": dict(speculative=True, draft_len=4),
    "w8_kv8": dict(chunked=True, prefix_cache=False, quant="w8_kv8"),
    "vlm": {},
    "vlm_w8_kv8": dict(quant="w8_kv8"),
}
CASES = ([(a, m, f) for a in ARCHS[:2] for m in ("chunked", "speculative")
          for f in (True, False) if f or m == "chunked"]
         + [("qwen3-0.6b", "whole_prompt", True),
            ("qwen3-0.6b", "w8_kv8", True), (VLM, "vlm", True),
            (VLM, "vlm", False), (VLM, "vlm_w8_kv8", True)])


@pytest.mark.parametrize("arch,mode,fused", CASES,
                         ids=[f"{a}-{m}-{'kernel' if f else 'eager'}"
                              for a, m, f in CASES])
def test_engine_greedy_tokens_equal_reference(weights, arch, mode, fused):
    jp, tp = weights[arch]
    j_cfg, t_cfg = _configs(arch, fused)
    prompts = _burst(t_cfg.vocab_size)
    # 16 tokens for the speculative engine: the reduced models fall into
    # short cycles there, so drafts get accepted as well as rolled back.
    new = 16 if mode == "speculative" else 8
    kw = dict(batch_slots=4, max_len=256, **ENGINES[mode])
    ref = JServingEngine(j_cfg, jp, **kw)
    want = [r.out_tokens for r in ref.generate([p.copy() for p in prompts],
                                               max_new_tokens=new)]
    eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=new)
    assert [r.out_tokens for r in got] == want
    m, jm = eng.metrics, ref.metrics
    assert {k: m[k] for k in COUNTERS} == {k: int(jm[k]) for k in COUNTERS}
    assert m["generated"] == new * len(prompts) and m["pages_in_use"] == 0
    assert eng.chunked == (arch != VLM and mode != "whole_prompt")
    if mode == "chunked":
        assert eng.prefix is not None and m["prefix_hit_pages"] > 0
    if mode == "speculative":
        assert m["accepted_tokens"] > 0 and m["rollbacks"] > 0
        plain = ServingEngine(t_cfg, tp, device="cpu", batch_slots=4,
                              max_len=256, prefix_cache=False)
        assert [r.out_tokens for r in plain.generate(
            prompts, max_new_tokens=new)] == want
    if mode.endswith("w8_kv8"):
        assert m["quant"] == jm["quant"] == "w8_kv8"
        assert m["kv_bytes_peak"] == jm["kv_bytes_peak"]
    eng.kv.assert_page_accounting(eng.cache)


def test_engine_refuses_chunked_prefill_and_speculation_for_mrope(weights):
    _, tp = weights[VLM]
    _, t_cfg = _configs(VLM, True)
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(t_cfg, tp, chunked=True, device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        ServingEngine(t_cfg, tp, speculative=True, device="cpu")
    with pytest.raises(ValueError, match="prefix_cache requires"):
        ServingEngine(t_cfg, tp, prefix_cache=True, device="cpu")
    j_cfg, _ = _configs(VLM, True)
    with pytest.raises(ValueError, match="chunked prefill"):
        JServingEngine(j_cfg, weights[VLM][0], chunked=True)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", VLM])
def test_accuracy_gate(weights, arch):
    """The port's teacher-forced gate on the reference's weights: qwen3's
    report equals the reference's (tokens; logit errors
    within 1e-4); qwen2-vl's unquantized stream equals the JAX engine's
    whole-prompt greedy tokens on the gate's prompt.  kv_int8 and w8_kv8
    keep the greedy stream under teacher forcing, errors below 0.5."""
    modes = ("kv_int8", "w8_kv8")
    steps = 6
    _, tp = weights[arch]
    got = run_accuracy(arch, modes=modes, steps=steps, params=tp,
                       device="cpu")
    if arch == VLM:
        j_cfg, _ = _configs(arch, False)
        prompt = np.random.default_rng(0).integers(
            1, j_cfg.vocab_size, 16).astype(np.int32)
        ref = JServingEngine(j_cfg, weights[arch][0], batch_slots=1,
                             max_len=64)
        assert got["none"]["tokens"] == ref.generate(
            [prompt], max_new_tokens=steps)[0].out_tokens
    else:
        want = j_run_accuracy(arch, modes=modes, steps=steps)
        assert got["none"]["tokens"] == want["none"]["tokens"]
        for mode in modes:
            assert got[mode]["tokens_equal"] == want[mode]["tokens_equal"]
            assert got[mode]["max_logit_err"] == pytest.approx(
                want[mode]["max_logit_err"], abs=1e-4)
            assert got[mode]["kv_itemsize"] == pytest.approx(
                want[mode]["kv_itemsize"])
    for mode in modes:
        assert got[mode]["tokens_equal"]
        assert got[mode]["max_logit_err"] < 0.5
