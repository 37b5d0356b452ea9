"""The port's engine serving gemma3-4b on the CPU, against
``repro.serving.ServingEngine``.

The reduced config (window 32, a global layer every 2), float32, the same
jittered weights (the JAX ``init_params`` and ``jitter_params`` through
the numpy bridge) and the same burst: prompts of 150, 40, 300 and 9
tokens, most longer than the window, a repeat of the 150-token prompt (a
prefix hit past the 128-token chunk) and a periodic prompt (n-gram
drafts).  The port's greedy tokens and counters must equal the JAX
engine's in every admission mode: chunked with the prefix cache (the
default) on the kernel and eager plans, whole-prompt, and speculative
verify (also equal to the port's plain engine).  On the CPU the kernel
plan runs each kernel's plain version.
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
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.serving import ServingEngine


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "gemma3-4b"
BURST = (150, 40, 300, 9)
COUNTERS = ("prefix_hit_pages", "prompt_pages", "draft_tokens",
            "accepted_tokens", "spec_tokens", "verify_dispatches",
            "rollbacks", "generated", "prefills", "prefill_chunks")


def _configs(fused: bool):
    j_cfg = dataclasses.replace(j_get_config(ARCH).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                                use_fused_kernels=fused)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def weights():
    j_cfg, t_cfg = _configs(False)
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(1), j_cfg), seed=1)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                                 device="cpu")


def _burst(vocab: int):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in BURST]
    return prompts + [prompts[0].copy(),
                      np.array([1, 2, 3, 4, 5, 6, 7, 8] * 5, np.int32)]


ENGINES = {
    "chunked": dict(chunked=True),
    "whole_prompt": dict(chunked=False, prefix_cache=False),
    "speculative": dict(speculative=True, draft_len=4),
}
CASES = [("chunked", True), ("chunked", False), ("whole_prompt", True),
         ("speculative", True)]


@pytest.mark.parametrize("mode,fused", CASES,
                         ids=[f"{m}-{'kernel' if f else 'eager'}"
                              for m, f in CASES])
def test_engine_greedy_tokens_equal_reference(weights, mode, fused):
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    prompts = _burst(t_cfg.vocab_size)
    # 24 tokens for the speculative engine: the reduced model falls into a
    # cycle there, so drafts are accepted as well as rolled back.
    new = 24 if mode == "speculative" else 8
    kw = dict(batch_slots=4, max_len=384, **ENGINES[mode])
    ref = JServingEngine(j_cfg, jp, **kw)
    want = [r.out_tokens for r in ref.generate([p.copy() for p in prompts],
                                               max_new_tokens=new)]
    eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=new)
    assert [r.out_tokens for r in got] == want
    m, jm = eng.metrics, ref.metrics
    assert {k: m[k] for k in COUNTERS} == {k: int(jm[k]) for k in COUNTERS}
    assert m["generated"] == new * len(prompts) and m["pages_in_use"] == 0
    assert eng.chunked == (mode != "whole_prompt")
    if mode == "chunked":
        assert eng.prefix is not None and m["prefix_hit_pages"] > 0
    if mode == "speculative":
        assert m["accepted_tokens"] > 0 and m["rollbacks"] > 0
        plain = ServingEngine(t_cfg, tp, device="cpu", batch_slots=4,
                              max_len=384, prefix_cache=False)
        assert [r.out_tokens for r in plain.generate(
            prompts, max_new_tokens=new)] == want
    eng.kv.assert_page_accounting(eng.cache)
