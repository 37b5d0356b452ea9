"""The port's contiguous slot cache on the CPU, against the JAX package.

``ServingEngine(paged=False)`` keeps ``slots x max_len`` K/V rows per
attention layer (``models.init_cache``), prefills whole prompts, places
the slot's rows and decodes without a page table (``decode_step``'s
contiguous branch, the plain ``decode_attention`` on every plan).  Held
to ``repro.serving.ServingEngine(paged=False)`` on the same bridged
float32 weights:

* greedy tokens exactly equal on a mixed burst (prompts of 40, 5, 33 and
  18 tokens on 3 slots, so a slot is handed to a later request mid-burst)
  for llama3-8b.reduced() on the kernel and eager plans, gpt2 reduced
  (jittered: zero LayerNorm scales zero every logit) and gemma3-4b
  reduced (jittered; its window of 32 is crossed by two prompts);
  ``kv_bytes_reserved`` (the worst-case rows), ``kv_bytes_peak`` and the
  cache gauges equal the reference's;
* the refusals the reference makes: a KV quant mode, chunked prefill,
  speculative decoding and the prefix cache;
* ``decode_step`` without a table on the kernel plan: logits at relative
  1e-5 for two slots at their own positions (gemma3, one past its window)
  after ``prefill`` placed into their rows;
* ``init_cache``: every leaf's shape and dtype, K/V and the zamba2 and
  rwkv6 state rows, against the reference's tree.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.serving import ServingEngine as JServingEngine
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro.serving.engine import _place_cache_slot as j_place_cache_slot
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, init_cache, params_from_numpy,
                                prefill)
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import _place_cache_slot

BURST = (40, 5, 33, 18)
NEW = 6
SLOTS, MAX_LEN = 3, 96
REL = 1e-5
# (arch, kernel plan, jitter)
CASES = [("llama3-8b", True, False), ("llama3-8b", False, False),
         ("gpt2", True, True), ("gemma3-4b", True, True)]
GAUGES = ("paged", "chunked", "prefill_chunk", "page_size",
          "kv_bytes_reserved", "kv_bytes_peak", "decode_block",
          "decode_block_last", "kv_itemsize_effective")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small CPU ops: one intra-op thread (restored after the
    module), so that test workers beside one another do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, fused, **kw):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="float32", use_fused_kernels=fused,
                                **kw)
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                use_fused_kernels=fused, **kw)
    return j_cfg, t_cfg


_WEIGHTS = {}


def _weights(arch, jitter):
    """The JAX weights (jittered where asked) and their port bridge, once
    per arch for the module."""
    if arch not in _WEIGHTS:
        j_cfg, t_cfg = _configs(arch, False)
        jp = j_init_params(jax.random.PRNGKey(3), j_cfg)
        if jitter:
            jp = j_jitter_params(jp, seed=3)
        _WEIGHTS[arch] = (jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), t_cfg, device="cpu"))
    return _WEIGHTS[arch]


def _burst(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in BURST]


@pytest.mark.parametrize("arch,fused,jitter", CASES,
                         ids=[f"{a}-{'kernel' if f else 'eager'}"
                              for a, f, _ in CASES])
def test_contiguous_tokens_equal_reference(arch, fused, jitter):
    jp, tp = _weights(arch, jitter)
    j_cfg, t_cfg = _configs(arch, fused)
    prompts = _burst(t_cfg.vocab_size)
    kw = dict(batch_slots=SLOTS, max_len=MAX_LEN, paged=False)
    ref = JServingEngine(j_cfg, jp, **kw)
    want = ref.generate(prompts, max_new_tokens=NEW)
    eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=NEW)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert len({tuple(r.out_tokens) for r in got}) > 1
    assert eng.kv is None and eng.prefix is None and eng.chunk == 0
    for name in GAUGES:
        assert eng.metrics[name] == ref.metrics[name], name
    for name in ("generated", "prefills", "dispatches", "ticks",
                 "scan_ticks", "prefill_chunks"):
        assert eng.metrics[name] == ref.metrics[name], name
    assert eng.kv_bytes_reserved == sum(
        eng.cache[n].numel() * eng.cache[n].element_size()
        for n in ("k", "v") if n in eng.cache)
    for r in got:
        assert r.done and not r.failed and r.ttft_s > 0 and r.tpot_s > 0


def test_contiguous_refuses_what_the_reference_refuses():
    jp, tp = _weights("llama3-8b", False)
    j_cfg, t_cfg = _configs("llama3-8b", False)
    for kw, match in ((dict(quant="kv_int8"), "paged cache"),
                      (dict(chunked=True), "paged cache"),
                      (dict(speculative=True), "paged cache"),
                      (dict(prefix_cache=True), "chunked prefill")):
        with pytest.raises(ValueError, match=match):
            JServingEngine(j_cfg, jp, paged=False, **kw)
        with pytest.raises(ValueError, match=match):
            ServingEngine(t_cfg, tp, paged=False, device="cpu", **kw)
    eng = ServingEngine(t_cfg, tp, paged=False, device="cpu")
    assert not eng.chunked and eng.prefix is None


def test_decode_step_without_table_matches_reference():
    jp, tp = _weights("gemma3-4b", True)
    j_cfg, t_cfg = _configs("gemma3-4b", True)
    prompts = _burst(t_cfg.vocab_size)[:2]               # 40 and 5 tokens
    j_cache = j_init_cache(j_cfg, 2, MAX_LEN)
    t_cache = init_cache(t_cfg, 2, MAX_LEN, device="cpu")
    for slot, p in enumerate(prompts):
        _, fresh = j_prefill(jp, j_cfg, {"tokens": jnp.asarray(p)[None]})
        j_cache = j_place_cache_slot(j_cache, fresh, jnp.int32(slot))
        _, tfresh = prefill(tp, t_cfg, torch.as_tensor(p)[None])
        _place_cache_slot(t_cache, tfresh, slot, t_cfg.kv_cache_layout)
    pos = np.array([len(p) for p in prompts], np.int32)
    tok = np.array([[7], [11]], np.int32)
    for step in range(3):
        jt, jl, j_cache = j_decode_step(jp, j_cfg, jnp.asarray(tok), j_cache,
                                        jnp.asarray(pos), jnp.asarray(pos))
        tt, tl, _ = decode_step(tp, t_cfg, torch.as_tensor(tok), t_cache,
                                torch.as_tensor(pos), torch.as_tensor(pos))
        want = np.asarray(jl, np.float64)
        err = np.abs(tl.numpy().astype(np.float64) - want).max()
        assert err <= REL * np.abs(want).max(), (step, err)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        tok = np.array(jt)
        pos = pos + 1


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-2.7b", "rwkv6-7b"])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_init_cache_leaves_match_reference(arch, layout):
    j_cfg, t_cfg = _configs(arch, False, kv_cache_layout=layout)
    j_cfg = dataclasses.replace(j_cfg, dtype="bfloat16")
    t_cfg = dataclasses.replace(t_cfg, dtype="bfloat16")
    got = init_cache(t_cfg, 3, 40, device="cpu")
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            j_init_cache(j_cfg, 3, 40))[0]:
        want.setdefault(path[-1].key, []).append(leaf)
    assert set(got) == set(want)
    for name, leaves in want.items():
        # The reference stacks pattern groups; the port one row per layer.
        rows = sum(int(a.shape[0]) for a in leaves)
        shape = (rows,) + tuple(leaves[0].shape[1:])
        assert tuple(got[name].shape) == shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaves[0].dtype)
        assert not got[name].any()
