"""The port's model entry points against ``repro.models`` on the CPU.

Same weights (the reference ``init_params`` through the numpy bridge), same
prompts, float32: ``prefill_chunk`` and ``decode_step`` logits, and the K/V
read back through the page table, with the kernel plan and the eager plan.
Logits are compared with a relative tolerance (max |diff| over max |ref|
<= 1e-5): the two frameworks sum in different orders, and an absolute 1e-6
is already missed by the reference against itself (ROADMAP queue 3).
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
from repro.models import prefill_chunk as j_prefill_chunk
from repro.serving.kv_cache import PagedKVCache as JPagedKVCache
from repro_torch.configs import get_config
from repro_torch.core.stream_plan import STAGES, plan_for
from repro_torch.models import (decode_step, init_params, model_defs,
                                params_from_numpy, prefill_chunk)
from repro_torch.serving.kv_cache import PagedKVCache, stage_chunk

REL = 1e-5


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _configs(fused: bool):
    j_cfg = dataclasses.replace(j_get_config("llama3-8b").reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                                dtype="float32", use_fused_kernels=fused)
    return j_cfg, t_cfg


def _same_kv_read_back(tkv, tcache, jcache, cfg, n):
    """Slot 0's first ``n`` K/V rows, read through its page table."""
    pages = tkv.slot_pages(0)
    shape = (cfg.num_layers, -1, cfg.num_kv_heads, cfg.head_dim_)
    for name in ("k", "v"):
        got = tcache[name][:, pages].reshape(shape)[:, :n]
        want = np.asarray(jcache["blocks"][0][name])[:, pages]
        _rel_close(got.numpy(), want.reshape(shape)[:, :n])


@pytest.fixture(scope="module")
def weights():
    j_cfg, t_cfg = _configs(False)
    jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                           device="cpu")
    return jp, tp


def test_configs_match_reference():
    for j_cfg, t_cfg in ((j_get_config("llama3-8b"), get_config("llama3-8b")),
                         (j_get_config("llama3-8b").reduced(),
                          get_config("llama3-8b").reduced())):
        assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)


def test_params_bridge_keeps_leaf_names_and_shapes(weights):
    jp, tp = weights
    _, t_cfg = _configs(False)
    defs = model_defs(t_cfg)
    assert len(tp["layers"]) == t_cfg.num_layers
    for i, layer in enumerate(tp["layers"]):
        for block, leaves in defs["layers"][i].items():
            for name, pd in leaves.items():
                got = layer[block][name]
                assert tuple(got.shape) == pd.shape
                want = np.asarray(jp["blocks"][0][block][name][i])
                np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(tp["lm_head"].shape) == defs["lm_head"].shape
    assert tp["embed"].dtype == torch.float32


def test_init_params_follows_the_reference_distributions():
    cfg = get_config("llama3-8b").reduced()
    p1 = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    p2 = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    assert torch.equal(p1["lm_head"], p2["lm_head"])          # seeded
    assert p1["lm_head"].dtype == torch.bfloat16               # cfg dtype
    assert torch.count_nonzero(p1["layers"][0]["ln1"]["scale"]) == 0
    wd = p1["layers"][0]["mlp"]["wd"].float()                  # fan_in = F
    assert abs(wd.std().item() * cfg.d_ff ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_chunk_and_decode_match_reference(weights, fused):
    """Two prefill chunks of a 150-token prompt into slot 0, then three
    decode steps with slot 1 idle (parked at the extent, length 0)."""
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    slots, max_len, ps, chunk = 2, 256, 16, 128
    jkv = JPagedKVCache(j_cfg, slots=slots, max_len=max_len, page_size=ps)
    tkv = PagedKVCache(t_cfg, slots=slots, max_len=max_len, page_size=ps,
                       device="cpu")
    jcache, tcache = jkv.init_cache(), tkv.init_cache()
    prompt = np.random.default_rng(0).integers(
        0, t_cfg.vocab_size, 150).astype(np.int32)
    for off in (0, chunk):
        jkv.ensure(0, min(off + chunk, max_len))
        tkv.ensure(0, min(off + chunk, max_len))
        row = tkv.table_row(0)
        np.testing.assert_array_equal(row, jkv.table_row(0))
        toks, cpages, last = stage_chunk(prompt, off, chunk, row, ps)
        jt, jl, jcache = j_prefill_chunk(jp, j_cfg, toks[None], jcache, row,
                                         cpages, off, last)
        tt, tl, tcache = prefill_chunk(
            tp, t_cfg, torch.from_numpy(toks)[None], tcache,
            torch.from_numpy(row), torch.from_numpy(cpages), off, last)
        _rel_close(tl.numpy(), jl)
        assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])
    _same_kv_read_back(tkv, tcache, jcache, t_cfg, 150)

    tok = np.array([[int(tt[0, 0])], [0]], np.int32)
    pos = np.array([150, tkv.extent], np.int32)
    lengths = np.array([150, 0], np.int32)
    for _ in range(3):
        jkv.ensure(0, int(pos[0]) + 1)
        tkv.ensure(0, int(pos[0]) + 1)
        jt, jl, jcache = j_decode_step(jp, j_cfg, tok, jcache, pos, lengths,
                                       page_table=jkv.page_table)
        tt, tl, tcache = decode_step(
            tp, t_cfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos),
            torch.from_numpy(lengths), page_table=tkv.page_table)
        _rel_close(tl.numpy()[0], np.asarray(jl)[0])
        assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])
        tok = tt.numpy().copy()
        pos, lengths = pos + 1, lengths + 1
    _same_kv_read_back(tkv, tcache, jcache, t_cfg, 153)


@pytest.mark.parametrize("arch", ["llama3-8b", "llama3-8b-reduced"])
def test_plan_for_matches_reference(arch):
    base, j_base = get_config("llama3-8b"), j_get_config("llama3-8b")
    if arch.endswith("reduced"):
        base, j_base = base.reduced(), j_base.reduced()
    cfg = dataclasses.replace(base, use_fused_kernels=True)
    j_cfg = dataclasses.replace(j_base, use_fused_kernels=True)
    for tokens, kv_len in ((4, 256), (20, 2048), (128, 2048)):
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
    for tokens in (64, 512, 4096):
        mine, ref = plan_for(cfg, tokens), j_plan_for(j_cfg, tokens)
        for stage in ("qkv", "attention", "ffn"):
            got = getattr(mine.layer("attn"), stage)
            want = getattr(ref.layer("attn"), stage)
            assert (got.implementation, got.blocks) == (
                want.implementation, want.blocks), stage
        assert (mine.lm_head.implementation, mine.lm_head.blocks) == (
            ref.lm_head.implementation, ref.lm_head.blocks)
    assert plan_for(base, 4, 256) is None          # eager config


def test_plan_for_refuses_unported_family():
    """Families still unported: qk-norm, qkv bias, a gated FFN under
    LayerNorm, an ungated MLP under RMSNorm."""
    llama = get_config("llama3-8b").reduced()
    gpt2 = get_config("gpt2").reduced()
    for base, change in ((llama, dict(qk_norm=True)),
                         (llama, dict(qkv_bias=True)),
                         (gpt2, dict(gated_ffn=True)),
                         (llama, dict(gated_ffn=False))):
        cfg = dataclasses.replace(base, use_fused_kernels=True, **change)
        with pytest.raises(NotImplementedError):
            plan_for(cfg, 4, 256)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("llama3-8b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(cfg, slots=1, max_len=32)
