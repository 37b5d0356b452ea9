"""The port's engine serving granite-moe on the CPU, against
``repro.serving.ServingEngine``.

Both granite configs reduced (4 experts, top-2), float32, the same weights
(the JAX ``init_params`` through the numpy bridge) and the same
mixed-length burst: the port's greedy tokens must equal the JAX engine's
exactly under chunked and whole-prompt admission on the kernel and eager
plans, with the prefix cache on (prefix hits counted alike), under
speculative verify (the speculative counters alike) and under ``w8_kv8``
(int8 KV pages and int8 qkv weights; the experts stay at full precision,
as K12 has no int8 twin).  On the CPU the kernel plan runs each kernel's
plain version.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.serving import ServingEngine

ARCHS = ("granite-moe-1b-a400m", "granite-moe-3b-a800m")
BURST = (5, 150, 37, 90, 17)
COUNTERS = ("prefix_hit_pages", "prompt_pages", "draft_tokens",
            "accepted_tokens", "spec_tokens", "verify_dispatches",
            "rollbacks", "generated")


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


@pytest.fixture(scope="module")
def weights():
    out = {}
    for i, arch in enumerate(ARCHS):
        j_cfg, t_cfg = _configs(arch, False)
        jp = j_init_params(jax.random.PRNGKey(i), j_cfg)
        out[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           t_cfg, device="cpu"))
    return out


def _burst(vocab: int):
    """The mixed burst, plus a repeat of the 150-token prompt (a prefix
    hit past the 128-token chunk) and a periodic prompt (n-gram drafts)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in BURST]
    return prompts + [prompts[1].copy(),
                      np.array([1, 2, 3, 4, 5, 6, 7, 8] * 5, np.int32)]


ENGINES = {
    "chunked": dict(chunked=True, prefix_cache=False),
    "whole_prompt": dict(chunked=False, prefix_cache=False),
    "prefix_cache": dict(chunked=True),
    "speculative": dict(speculative=True, draft_len=4),
    "w8_kv8": dict(chunked=True, prefix_cache=False, quant="w8_kv8"),
}
CASES = [(mode, fused) for mode in ENGINES for fused in (True, False)
         if fused or mode in ("chunked", "whole_prompt")]


@pytest.mark.parametrize("mode,fused", CASES,
                         ids=[f"{m}-{'kernel' if f else 'eager'}"
                              for m, f in CASES])
@pytest.mark.parametrize("arch", ARCHS)
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
    if mode == "prefix_cache":
        assert m["prefix_hit_pages"] > 0
    if mode == "speculative":
        assert m["accepted_tokens"] > 0 and m["rollbacks"] > 0
    if mode == "w8_kv8":
        assert m["quant"] == jm["quant"] == "w8_kv8"
        assert m["kv_bytes_peak"] == jm["kv_bytes_peak"]
    eng.kv.assert_page_accounting(eng.cache)
