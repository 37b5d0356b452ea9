"""gpt2 through the port on the CPU, against the JAX package.

gpt2 is the LayerNorm / MHA / GELU-MLP / learned-position family: its plan
selects ``block_matmul`` for qkv, ``streamed_mlp`` (no folded norm) for the
FFN, the offset flash kernel for chunked prefill, the static flash kernel
for whole-prompt prefill, and paged decode attention.  Both sides run
float32 on the same weights: the reference ``init_params`` jittered by the
reference ``jitter_params`` (zero LayerNorm scales would make every gpt2
logit zero, and every comparison vacuous), bridged with
``params_from_numpy``.  Logits match at relative 1e-5 (max |diff| over
max |ref|, as in ``test_torch_model.py``); greedy tokens match exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.stream_plan import plan_for as j_plan_for
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models import prefill_chunk as j_prefill_chunk
from repro.models.layers import layer_norm as j_layer_norm
from repro.serving import ServingEngine as JServingEngine
from repro.serving import kv_cache as jkv
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro_torch.configs import get_config
from repro_torch.core.stream_plan import STAGES, plan_for
from repro_torch.models import (decode_step, init_params, model_defs,
                                params_from_numpy, prefill, prefill_chunk)
from repro_torch.models.layers import layer_norm
from repro_torch.serving import PagedKVCache, ServingEngine
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.accuracy import jitter_params

REL = 1e-5
BURST = (5, 200, 37, 130, 64, 17)


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _configs(fused: bool):
    j_cfg = dataclasses.replace(j_get_config("gpt2").reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config("gpt2").reduced(),
                                dtype="float32", use_fused_kernels=fused)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def weights():
    j_cfg, t_cfg = _configs(False)
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(0), j_cfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                           device="cpu")
    return jp, tp


def _prompt(n: int, seed: int = 0) -> np.ndarray:
    vocab = get_config("gpt2").reduced().vocab_size
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def test_configs_match_reference():
    for j_cfg, t_cfg in ((j_get_config("gpt2"), get_config("gpt2")),
                         (j_get_config("gpt2").reduced(),
                          get_config("gpt2").reduced())):
        assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)


@pytest.mark.parametrize("arch", ["gpt2", "gpt2-reduced"])
def test_plan_for_matches_reference(arch):
    base, j_base = get_config("gpt2"), j_get_config("gpt2")
    if arch.endswith("reduced"):
        base, j_base = base.reduced(), j_base.reduced()
    cfg = dataclasses.replace(base, use_fused_kernels=True)
    j_cfg = dataclasses.replace(j_base, use_fused_kernels=True)
    for tokens, kv_len in ((4, 256), (20, 1024), (128, 1024),
                           (512, 2048)):
        mine, ref = plan_for(cfg, tokens, kv_len), j_plan_for(j_cfg, tokens,
                                                              kv_len)
        assert [k for k, _ in mine.layers] == [k for k, _ in ref.layers]
        for kind, lp in mine.layers:
            rlp = ref.layer(kind)
            for stage in STAGES:
                got, want = getattr(lp, stage), getattr(rlp, stage)
                assert got.implementation == want.implementation, stage
                assert got.blocks == want.blocks, stage
        ps = mine.decode_page_size()
        assert ps == ref.decode_page_size()
        assert mine.prefill_chunk_size(ps) == ref.prefill_chunk_size(ps)
        for draft_len in (1, 4, 20):
            assert (mine.verify_window(draft_len)
                    == ref.verify_window(draft_len))
    # A training step's tokens (``forward_train``: no KV length): the
    # stages it runs, and the loss (final norm + LM head + streamed xent).
    for tokens in (64, 512, 8192):
        mine, ref = plan_for(cfg, tokens), j_plan_for(j_cfg, tokens)
        for stage in ("qkv", "attention", "ffn"):
            got = getattr(mine.layer("attn"), stage)
            want = getattr(ref.layer("attn"), stage)
            assert (got.implementation, got.blocks) == (
                want.implementation, want.blocks), stage
        assert (mine.lm_head.implementation, mine.lm_head.blocks) == (
            ref.lm_head.implementation, ref.lm_head.blocks)
    assert plan_for(base, 4, 256) is None          # eager config


def test_params_bridge_keeps_norm_biases_and_positions(weights):
    jp, tp = weights
    _, t_cfg = _configs(False)
    defs = model_defs(t_cfg)
    assert tuple(defs["pos_embed"].shape) == (32_768, t_cfg.d_model)
    np.testing.assert_array_equal(tp["pos_embed"].numpy(),
                                  np.asarray(jp["pos_embed"]))
    for i, layer in enumerate(tp["layers"]):
        for block, leaves in defs["layers"][i].items():
            assert set(layer[block]) == set(leaves), block
            for name in leaves:
                np.testing.assert_array_equal(
                    layer[block][name].numpy(),
                    np.asarray(jp["blocks"][0][block][name][i]))
    assert set(tp["final_norm"]) == {"scale", "bias"}
    assert set(defs["layers"][0]["mlp"]) == {"wu", "wd"}


def test_layer_norm_matches_reference():
    """Population variance (``correction=0``) and eps 1e-5, raw gain."""
    rng = np.random.default_rng(1)
    x = (3.0 + rng.standard_normal((5, 64))).astype(np.float32)
    s, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    got = layer_norm(*(torch.from_numpy(a) for a in (x, s, b)))
    want = j_layer_norm(*(jax.numpy.asarray(a) for a in (x, s, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_jittered_logits_are_not_all_zero(weights):
    """Zero-initialised LayerNorm scales zero every logit; jitter does not."""
    _, tp = weights
    _, t_cfg = _configs(False)
    tokens = torch.from_numpy(_prompt(12))[None]
    plain = init_params(t_cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    for params, all_zero in ((plain, True), (tp, False)):
        logits, _ = prefill(params, t_cfg, tokens)
        live = logits[..., :t_cfg.vocab_size]
        assert bool((live == 0).all()) == all_zero


def test_jitter_params_is_seeded_and_keeps_dtypes():
    cfg = get_config("gpt2").reduced()
    p = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    a = jitter_params(p, torch.Generator().manual_seed(4))
    b = jitter_params(p, torch.Generator().manual_seed(4))
    assert torch.equal(a["pos_embed"], b["pos_embed"])
    scale = a["layers"][0]["ln1"]["scale"]
    assert scale.dtype == torch.bfloat16                  # cfg dtype
    assert abs(scale.float().std().item() - 0.05) < 0.02
    assert torch.count_nonzero(p["layers"][0]["ln1"]["scale"]) == 0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_prefill_matches_reference(weights, fused):
    """Whole-prompt ``prefill``: last-position logits and every layer's
    K/V, at a prompt length no tile divides."""
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    prompt = _prompt(37)
    jl, jcache = j_prefill(jp, j_cfg, {"tokens": prompt[None]})
    tl, tcache = prefill(tp, t_cfg, torch.from_numpy(prompt)[None])
    _rel_close(tl.numpy(), jl)
    for name in ("k", "v"):
        _rel_close(tcache[name].numpy(),
                   np.asarray(jcache["blocks"][0][name]))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_chunk_and_decode_match_reference(weights, fused):
    """Two prefill chunks of a 150-token prompt into slot 0 (the second
    with pad rows, which get position rows too), then three decode steps
    with slot 1 idle (parked at the extent, length 0)."""
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    slots, max_len, ps, chunk = 2, 256, 16, 128
    jkvc = jkv.PagedKVCache(j_cfg, slots=slots, max_len=max_len,
                            page_size=ps)
    tkvc = PagedKVCache(t_cfg, slots=slots, max_len=max_len, page_size=ps,
                        device="cpu")
    jcache, tcache = jkvc.init_cache(), tkvc.init_cache()
    prompt = _prompt(150)
    for off in (0, chunk):
        jkvc.ensure(0, min(off + chunk, max_len))
        tkvc.ensure(0, min(off + chunk, max_len))
        row = tkvc.table_row(0)
        toks, cpages, last = tkv.stage_chunk(prompt, off, chunk, row, ps)
        jt, jl, jcache = j_prefill_chunk(jp, j_cfg, toks[None], jcache, row,
                                         cpages, off, last)
        tt, tl, tcache = prefill_chunk(
            tp, t_cfg, torch.from_numpy(toks)[None], tcache,
            torch.from_numpy(row), torch.from_numpy(cpages), off, last)
        _rel_close(tl.numpy(), jl)
        assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])

    tok = np.array([[int(tt[0, 0])], [0]], np.int32)
    pos = np.array([150, tkvc.extent], np.int32)
    lengths = np.array([150, 0], np.int32)
    for _ in range(3):
        jkvc.ensure(0, int(pos[0]) + 1)
        tkvc.ensure(0, int(pos[0]) + 1)
        jt, jl, jcache = j_decode_step(jp, j_cfg, tok, jcache, pos, lengths,
                                       page_table=jkvc.page_table)
        tt, tl, tcache = decode_step(
            tp, t_cfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos),
            torch.from_numpy(lengths), page_table=tkvc.page_table)
        _rel_close(tl.numpy()[0], np.asarray(jl)[0])
        assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])
        tok = tt.numpy().copy()
        pos, lengths = pos + 1, lengths + 1
    pages = tkvc.slot_pages(0)
    shape = (t_cfg.num_layers, -1, t_cfg.num_kv_heads, t_cfg.head_dim_)
    for name in ("k", "v"):
        got = tcache[name][:, pages].reshape(shape)[:, :153]
        want = np.asarray(jcache["blocks"][0][name])[:, pages]
        _rel_close(got.numpy(), want.reshape(shape)[:, :153])


def test_place_prefill_matches_reference():
    rng = np.random.default_rng(5)
    layers, pages, ps, h, d, s = 2, 9, 4, 2, 3, 10
    pools = {n: rng.standard_normal((layers, pages, ps, h, d))
             .astype(np.float32) for n in ("k", "v")}
    fresh = {n: rng.standard_normal((layers, 1, s, h, d)).astype(np.float32)
             for n in ("k", "v")}
    slot_pages = np.array([7, 2, 5], np.int32)        # cdiv(10, 4) pages
    want = jkv.place_prefill(
        {"blocks": ({n: jax.numpy.asarray(a) for n, a in pools.items()},),
         "rest": ()},
        {"blocks": (fresh,), "rest": ()}, 1, slot_pages, layout="bshd")
    got = tkv.place_prefill(
        {n: torch.from_numpy(a.copy()) for n, a in pools.items()},
        {n: torch.from_numpy(a) for n, a in fresh.items()},
        torch.from_numpy(slot_pages), layout="bshd")
    for n in ("k", "v"):
        np.testing.assert_array_equal(got[n].numpy(),
                                      np.asarray(want["blocks"][0][n]))


@pytest.mark.parametrize("chunked", [True, False],
                         ids=["chunked", "whole_prompt"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_engine_greedy_tokens_equal_reference(weights, fused, chunked):
    """The mixed burst (6 prompts of 5..200 tokens, 4 slots, max_len 256,
    8 new tokens) through both engines, no prefix cache."""
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    prompts = [_prompt(n, seed=i) for i, n in enumerate(BURST)]
    ref = JServingEngine(j_cfg, jp, batch_slots=4, max_len=256,
                         chunked=chunked, prefix_cache=False).generate(
                             prompts, max_new_tokens=8)
    eng = ServingEngine(t_cfg, tp, batch_slots=4, max_len=256,
                        chunked=chunked, device="cpu")
    got = eng.generate(prompts, max_new_tokens=8)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in ref]
    m = eng.metrics
    assert m["generated"] == 8 * len(BURST)
    assert m["prefills"] == len(BURST)
    assert m["prefill_chunks"] == (
        sum(-(-n // eng.chunk) for n in BURST) if chunked else 0)
    for r in got:
        assert r.done and not r.failed
        assert r.ttft_s > 0 and r.tpot_s > 0
    eng.kv.assert_page_accounting(eng.cache)


def test_engine_defaults_to_chunked_admission(weights):
    _, tp = weights
    _, t_cfg = _configs(False)
    assert ServingEngine(t_cfg, tp, batch_slots=1, max_len=64,
                         device="cpu").chunked
