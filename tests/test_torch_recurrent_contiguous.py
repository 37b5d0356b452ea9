"""The port's contiguous slot cache for the recurrent stacks on the CPU,
against the JAX package.

zamba2-2.7b.reduced() (Mamba2 layers and the shared attention block:
``ssm``/``conv`` state rows beside K/V rows) and rwkv6-7b.reduced() (no
K/V at all: ``wkv``/``tm_shift``/``cm_shift`` rows) through
``ServingEngine(paged=False)`` hold the greedy tokens of
``repro.serving.ServingEngine(paged=False)`` exactly, on the same bridged
float32 weights (rwkv6 jittered: zero LayerNorm scales and unit mixes
zero every logit), on a mixed burst (prompts of 40, 5, 33 and 18 tokens
on 3 slots, so a slot is handed to a later request mid-burst), with the
kernel plan and with the eager plan (on the CPU both run the plain
versions).  One reference run per config serves both plans.
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

BURST = (40, 5, 33, 18)
NEW = 6
SLOTS, MAX_LEN = 3, 96
ARCHS = {"zamba2-2.7b": False, "rwkv6-7b": True}      # arch: jitter
GAUGES = ("paged", "chunked", "prefill_chunk", "page_size",
          "kv_bytes_reserved", "kv_bytes_peak", "decode_block",
          "decode_block_last")
COUNTERS = ("generated", "prefills", "dispatches", "ticks", "scan_ticks",
            "prefill_chunks")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small CPU ops: one intra-op thread (restored after the
    module), so that test workers beside one another do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _burst(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in BURST]


@pytest.fixture(scope="module")
def reference():
    """Per arch: the bridged weights, the prompts, and the reference
    contiguous engine after its burst (one run each)."""
    out = {}
    for arch, jitter in ARCHS.items():
        j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                    dtype="float32")
        jp = j_init_params(jax.random.PRNGKey(3), j_cfg)
        if jitter:
            jp = j_jitter_params(jp, seed=3)
        prompts = _burst(j_cfg.vocab_size)
        eng = JServingEngine(j_cfg, jp, batch_slots=SLOTS, max_len=MAX_LEN,
                             paged=False)
        reqs = eng.generate(prompts, max_new_tokens=NEW)
        out[arch] = (jax.tree.map(np.asarray, jp), prompts, eng,
                     [r.out_tokens for r in reqs])
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_contiguous_recurrent_tokens_equal_reference(reference, arch,
                                                     fused):
    jp, prompts, ref, want = reference[arch]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              use_fused_kernels=fused)
    params = params_from_numpy(jp, cfg, device="cpu")
    eng = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN,
                        paged=False, device="cpu")
    got = eng.generate(prompts, max_new_tokens=NEW)
    assert [r.out_tokens for r in got] == want
    assert len({tuple(t) for t in want}) > 1
    assert all(len(t) == NEW for t in want)
    assert eng.kv is None and eng.prefix is None
    for name in GAUGES + COUNTERS:
        assert eng.metrics[name] == ref.metrics[name], name
