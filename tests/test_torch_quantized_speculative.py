"""The port's quantized speculative engine against the JAX one on the CPU.

``ServingEngine(speculative=True, quant=m)`` for m in kv_int8 and w8_kv8,
on the speculative burst of ``test_torch_speculative.py`` (a shared
160-token prefix, distinct suffixes, a verbatim repeat and a periodic
prompt), with gpt2-reduced (jittered), llama3-8b-reduced and
granite-moe-1b-a400m-reduced, kernel plan, float32, the same weights on
both sides: greedy tokens, ``accept_rate``, rollbacks and the other
speculative and prefix counters must be equal.  Rejected draft rows grow
their pages' scales in both engines alike, so a quantized speculative run
need not equal the quantized plain engine, but it must equal the
reference's.

Also the one place where the port's quantized pages differ from the
reference on purpose: a page the allocator hands out again starts at scale
0, as a fresh pool's pages do, where the reference keeps its previous
owner's scale and so makes a request's tokens depend on the traffic before
it.  The port serves each request of a burst that recycles pages as the
reference serves it alone.
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
from repro_torch.serving import kv_cache as tkv

ARCHS = ("gpt2", "llama3-8b", "granite-moe-1b-a400m")
COUNTERS = ("prefix_hit_pages", "prompt_pages", "draft_tokens",
            "accepted_tokens", "spec_tokens", "verify_dispatches",
            "rollbacks", "rollback_pages", "generated")


def _configs(arch: str):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="float32", use_fused_kernels=True)
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                use_fused_kernels=True)
    return j_cfg, t_cfg


def _burst(vocab: int):
    """``test_torch_speculative._burst``: a shared 160-token prefix with
    three suffixes, the first prompt again, and a periodic prompt."""
    rng = np.random.default_rng(8)
    shared = rng.integers(0, vocab, 160).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)
                               .astype(np.int32)]) for n in (10, 70, 3)]
    prompts.append(prompts[0].copy())
    prompts.append(np.array([1, 2, 3, 4, 5, 6, 7, 8] * 6, np.int32))
    return prompts


@pytest.mark.parametrize("mode", ["kv_int8", "w8_kv8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_speculative_engine_matches_reference(arch, mode):
    j_cfg, t_cfg = _configs(arch)
    jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
    if arch == "gpt2":           # zero LayerNorm scales zero every logit
        jp = j_jitter_params(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg, device="cpu")
    prompts = _burst(t_cfg.vocab_size)
    kw = dict(batch_slots=2, max_len=512, speculative=True, draft_len=4,
              quant=mode)
    ref = JServingEngine(j_cfg, jp, **kw)
    want = [r.out_tokens for r in ref.generate([p.copy() for p in prompts],
                                               max_new_tokens=12)]
    eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
    eng._debug_check_pages = True
    got = [r.out_tokens for r in eng.generate(prompts, max_new_tokens=12)]
    assert got == want
    m, jm = eng.metrics, ref.metrics
    assert {k: m[k] for k in COUNTERS} == {k: int(jm[k]) for k in COUNTERS}
    assert m["accept_rate"] == jm["accept_rate"]
    assert m["quant"] == jm["quant"] == mode
    assert m["draft_tokens"] > 0 and m["rollbacks"] > 0
    eng.kv.assert_page_accounting(eng.cache)


@pytest.mark.parametrize("quant", ["kv_int8", "kv_fp8"])
def test_reused_page_starts_its_scale_afresh(quant):
    """A page that held another slot's large codes and scale, released and
    handed out again by ``ensure``, takes decode appends exactly as a page
    of a fresh pool does: the same codes and the same scale."""
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32", quant=quant)
    rng = np.random.default_rng(3)
    h, d = cfg.num_kv_heads, cfg.head_dim_
    toks = [torch.from_numpy(rng.standard_normal((1, 1, h, d))
                             .astype(np.float32)) for _ in range(3)]
    out = []
    for stale in (False, True):
        kv = tkv.PagedKVCache(cfg, slots=1, max_len=64, page_size=4,
                              device="cpu")
        cache = kv.init_cache()
        pool, scale = cache["k"][0], cache["k_scale"][0]
        if stale:
            pages = torch.as_tensor(kv.ensure(0, 8)).long()
            big = torch.full((2, 4, h, d), 50.0)
            pool[pages] = tkv.quantize_kv(big, torch.full((2, 1, h, 1), 0.5),
                                          pool.dtype)
            scale[pages] = 0.5
            kv.release(0)
        table = torch.as_tensor(kv.ensure(0, 4 + len(toks)))[None]
        for i, tok in enumerate(toks):
            tkv.paged_append_q(pool, scale, table,
                               torch.tensor([4 + i], dtype=torch.int32),
                               tok, layout="bshd")
        page = int(table[0, 1])
        out.append((page, pool[page].view(torch.uint8).clone(),
                    scale[page].clone()))
    assert out[0][0] == out[1][0]            # the same page, reused
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])
    assert float(out[1][2].max()) < 0.5


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["whole_prompt", "chunked"])
def test_recycled_pages_serve_each_request_as_alone(chunked):
    """A burst that hands a request pages a loud earlier request used:
    under kv_int8 the port gives each request the tokens the JAX engine
    gives it served alone on fresh pages.  Tokens at the end of the
    vocabulary embed along one axis that layer 0's key and value
    projections scale up a hundredfold, so the first request's pages carry
    scales far above the second's.  Under whole-prompt admission the
    second request decodes into those pages (the chunked path overwrites
    every page of a prompt chunk, padding included), and there the JAX
    burst gives the second request other tokens than serving it alone."""
    j_cfg, t_cfg = _configs("llama3-8b")
    jp = jax.tree.map(np.array, j_init_params(jax.random.PRNGKey(0), j_cfg))
    v = t_cfg.vocab_size
    jp["embed"][:, 0] = 0.0
    jp["embed"][v - 4:] = 0.0
    jp["embed"][v - 4:, 0] = 1.0
    for w in ("wk", "wv"):
        jp["blocks"][0]["attn"][w][0, 0] *= 100.0
    tp = params_from_numpy(jp, t_cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(v - 4, v, 100).astype(np.int32),
               rng.integers(0, v - 4, 15).astype(np.int32)]
    kw = dict(batch_slots=1, max_len=256, chunked=chunked,
              prefix_cache=False, quant="kv_int8")
    new = 24
    j_burst = [r.out_tokens for r in JServingEngine(j_cfg, jp, **kw).generate(
        [p.copy() for p in prompts], max_new_tokens=new)]
    j_alone = JServingEngine(j_cfg, jp, **kw).generate(
        [prompts[1].copy()], max_new_tokens=new)[0].out_tokens
    eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
    got = [r.out_tokens for r in eng.generate(prompts, max_new_tokens=new)]
    assert got == [j_burst[0], j_alone]
    assert (j_burst[1] != j_alone) is not chunked
