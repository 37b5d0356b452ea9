"""The port's Qwen decoders on the CPU, against the JAX package.

qwen3-0.6b (qk-norm, GQA), qwen1.5-0.5b (the QKV bias) and qwen2-vl-2b
(the QKV bias, M-RoPE and a patch-embedding input):

* the configs, full and reduced, equal the reference's field by field;
* the bridge carries the new attention leaves (``bq``/``bk``/``bv``,
  ``q_norm``/``k_norm``) by name and shape, both ways bit for bit;
* ``plan_for`` is pinned to the reference's for each config, full and
  reduced, at serving and training token counts (``lm_head`` included),
  and is llama3-8b's plan stage for stage;
* ``apply_mrope`` against the reference's on distinct temporal, height and
  width positions (where it is not RoPE), and RoPE where the axes agree;
* ``prefill`` (tokens; qwen2-vl also ``embeds`` with distinct M-RoPE
  axes), ``prefill_chunk``, ``decode_step`` and ``verify_step`` (qwen3,
  qwen1.5), and qwen2-vl's placed whole prompts then ``decode_step``,
  logits at relative 1e-5 on both plans.

Weights: the reference ``init_params`` jittered
(``repro.serving.accuracy.jitter_params``), then the numpy bridge: the
biases and the q/k norm scales start at zero, so unjittered weights would
let every check on them pass for nothing.  Float32 on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from test_torch_stream_plan import j_plan_for  # the reference on H100
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import prefill as j_prefill
from repro.models import prefill_chunk as j_prefill_chunk
from repro.models import verify_step as j_verify_step
from repro.serving import PagedKVCache as JPagedKVCache
from repro.serving import kv_cache as jkv
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro_torch.configs import get_config
from repro_torch.core.stream_plan import STAGES, plan_for
from repro_torch.models import (decode_step, layers as L, model_defs,
                                params_from_numpy, params_to_numpy, prefill,
                                prefill_chunk, verify_step)
from repro_torch.models.params import tree_leaves
from repro_torch.serving import PagedKVCache
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.kv_cache import stage_chunk


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REL = 1e-5
ARCHS = ("qwen3-0.6b", "qwen1.5-0.5b", "qwen2-vl-2b")
CHUNKED = ("qwen3-0.6b", "qwen1.5-0.5b")
VLM = "qwen2-vl-2b"
# The attention leaves each config adds to the projections, in the
# reference's order (``params.py:75-90``).
EXTRA_LEAVES = {"qwen3-0.6b": ("q_norm", "k_norm"),
                "qwen1.5-0.5b": ("bq", "bk", "bv"),
                VLM: ("bq", "bk", "bv")}


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


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
        jp = j_jitter_params(j_init_params(jax.random.PRNGKey(i), j_cfg),
                             seed=10 + i)
        out[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           t_cfg, device="cpu"))
    return out


def _mrope_positions(rng, b, s):
    """Distinct temporal, height and width axes [3, B, S]: a patch grid's
    rows and columns beside a running time index."""
    t = np.broadcast_to(np.arange(s), (b, s))
    h = t // 7 + rng.integers(0, 3, (b, 1))
    w = t % 7
    return np.stack([t, h, w]).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for j_cfg, t_cfg in ((j_get_config(arch), get_config(arch)),
                         (j_get_config(arch).reduced(),
                          get_config(arch).reduced())):
        assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_bridge_carries_qwen_leaves_both_ways(weights, arch):
    jp, tp = weights[arch]
    _, t_cfg = _configs(arch, False)
    attn = model_defs(t_cfg)["layers"][0]["attn"]
    assert list(attn) == ["wq", "wk", "wv", "wo", *EXTRA_LEAVES[arch]]
    assert set(attn) == set(jp["blocks"][0]["attn"])
    dq, dkv, hd = t_cfg.q_dim, t_cfg.kv_dim, t_cfg.head_dim_
    want = {"bq": (dq,), "bk": (dkv,), "bv": (dkv,), "q_norm": (hd,),
            "k_norm": (hd,)}
    for name in EXTRA_LEAVES[arch]:
        assert attn[name].shape == want[name] and attn[name].init == "zeros"
        for i, layer in enumerate(tp["layers"]):
            got = layer["attn"][name].numpy()
            np.testing.assert_array_equal(
                got, np.asarray(jp["blocks"][0]["attn"][name][i]))
            assert np.abs(got).max() > 0          # jittered, not zero
    back = params_to_numpy(tp, t_cfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jp))[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_back, flat_ref):
        np.testing.assert_array_equal(a, b)
    again = params_from_numpy(back, t_cfg, device="cpu")
    for a, b in zip(tree_leaves(again), tree_leaves(tp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS + tuple(a + "-reduced"
                                               for a in ARCHS))
def test_plan_for_matches_reference(arch):
    name = arch.removesuffix("-reduced")
    base, j_base = get_config(name), j_get_config(name)
    llama = get_config("llama3-8b")
    if arch.endswith("-reduced"):
        base, j_base, llama = base.reduced(), j_base.reduced(), \
            llama.reduced()
    cfg = dataclasses.replace(base, use_fused_kernels=True)
    j_cfg = dataclasses.replace(j_base, use_fused_kernels=True)
    llama = dataclasses.replace(llama, use_fused_kernels=True)
    for tokens, kv_len in ((4, 256), (20, 2048), (128, 2048)):
        mine, ref = plan_for(cfg, tokens, kv_len), j_plan_for(j_cfg, tokens,
                                                              kv_len)
        assert [k for k, _ in mine.layers] == [k for k, _ in ref.layers]
        same = plan_for(llama, tokens, kv_len).layer("attn")
        for kind, lp in mine.layers:
            for stage in STAGES:
                got, want = getattr(lp, stage), getattr(ref.layer(kind),
                                                        stage)
                assert (got.implementation, got.blocks) == (
                    want.implementation, want.blocks), (stage, tokens)
                assert got == getattr(same, stage)
        ps = mine.decode_page_size()
        assert ps == ref.decode_page_size()
        assert mine.prefill_chunk_size(ps) == ref.prefill_chunk_size(ps)
        for draft_len in (1, 4, 20):
            assert (mine.verify_window(draft_len)
                    == ref.verify_window(draft_len))
    # A training step's tokens: the stages it runs and the loss.
    for tokens in (64, 512, 4096):
        mine, ref = plan_for(cfg, tokens), j_plan_for(j_cfg, tokens)
        for stage in ("qkv", "attention", "ffn"):
            got = getattr(mine.layer("attn"), stage)
            want = getattr(ref.layer("attn"), stage)
            assert (got.implementation, got.blocks) == (
                want.implementation, want.blocks), (stage, tokens)
        assert (mine.lm_head.implementation, mine.lm_head.blocks) == (
            ref.lm_head.implementation, ref.lm_head.blocks)
    assert plan_for(base, 4, 256) is None          # eager config


@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope_matches_reference(head_dim):
    rng = np.random.default_rng(5)
    b, s, h = 2, 40, 3
    x = rng.standard_normal((b, s, h, head_dim)).astype(np.float32)
    pos = _mrope_positions(rng, b, s)
    want = np.asarray(JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _rel_close(got.numpy(), want)
    assert L.MROPE_SECTIONS == JL.MROPE_SECTIONS
    # Distinct axes: not RoPE at the temporal positions ...
    rope = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6)
    assert (got - rope).abs().max() > 1e-3
    # ... equal axes: RoPE, and ``apply_positional`` routes to it.
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    eq = L.apply_positional("mrope", torch.from_numpy(x),
                            torch.from_numpy(same), 1e6)
    torch.testing.assert_close(eq, rope, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(weights, arch, fused):
    jp, tp = weights[arch]
    j_cfg, t_cfg = _configs(arch, fused)
    tokens = np.random.default_rng(3).integers(
        0, t_cfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jc = j_prefill(jp, j_cfg, {"tokens": jnp.asarray(tokens)})
    tl, tc = prefill(tp, t_cfg, torch.from_numpy(tokens))
    _rel_close(tl.numpy(), jl)
    for name in ("k", "v"):
        _rel_close(tc[name].numpy(), np.asarray(jc["blocks"][0][name]))


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
def test_prefill_on_patch_embeddings_matches_reference(weights, fused):
    """qwen2-vl on a frontend's ``embeds`` [B, S, D] (not scaled) with
    distinct M-RoPE axes, and with the default positions (all three axes
    the token positions)."""
    jp, tp = weights[VLM]
    j_cfg, t_cfg = _configs(VLM, fused)
    rng = np.random.default_rng(6)
    b, s = 2, 40
    embeds = (0.5 * rng.standard_normal((b, s, t_cfg.d_model))
              ).astype(np.float32)
    pos = _mrope_positions(rng, b, s)
    outs = []
    for positions in (pos, None):
        batch = {"embeds": jnp.asarray(embeds)}
        if positions is not None:
            batch["positions"] = jnp.asarray(positions)
        jl, jc = j_prefill(jp, j_cfg, batch)
        tl, tc = prefill(tp, t_cfg, embeds=torch.from_numpy(embeds),
                         positions=(None if positions is None
                                    else torch.from_numpy(positions)))
        _rel_close(tl.numpy(), jl)
        for name in ("k", "v"):
            _rel_close(tc[name].numpy(), np.asarray(jc["blocks"][0][name]))
        outs.append(tl)
    assert (outs[0] - outs[1]).abs().max() > 0       # the axes mattered


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
@pytest.mark.parametrize("arch", CHUNKED)
def test_chunk_decode_and_verify_match_reference(weights, arch, fused):
    """Two prefill chunks of a 100-token prompt into slot 0, two decode
    steps with slot 1 idle, then a 5-row verify window."""
    jp, tp = weights[arch]
    j_cfg, t_cfg = _configs(arch, fused)
    slots, max_len, ps, chunk, w = 2, 160, 16, 64, 5
    jk = JPagedKVCache(j_cfg, slots=slots, max_len=max_len, page_size=ps)
    tk = PagedKVCache(t_cfg, slots=slots, max_len=max_len, page_size=ps,
                      device="cpu")
    jcache, tcache = jk.init_cache(), tk.init_cache()
    rng = np.random.default_rng(4)
    plen = 100
    prompt = rng.integers(0, t_cfg.vocab_size, plen).astype(np.int32)
    for off in (0, chunk):
        for kc in (jk, tk):
            kc.ensure(0, min(off + chunk, max_len))
        row = tk.table_row(0)
        toks, cpages, last = stage_chunk(prompt, off, chunk, row, ps)
        jt, jl, jcache = j_prefill_chunk(jp, j_cfg, toks[None], jcache, row,
                                         cpages, off, last)
        tt, tl, tcache = prefill_chunk(
            tp, t_cfg, torch.from_numpy(toks)[None], tcache,
            torch.from_numpy(row), torch.from_numpy(cpages), off, last)
        _rel_close(tl.numpy(), jl)
        assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])
    tok = np.array([[int(tt[0, 0])], [0]], np.int32)
    pos = np.array([plen, tk.extent], np.int32)
    lengths = np.array([plen, 0], np.int32)
    for _ in range(2):
        for kc in (jk, tk):
            kc.ensure(0, int(pos[0]) + 1)
        jt, jl, jcache = j_decode_step(jp, j_cfg, tok, jcache, pos, lengths,
                                       page_table=jk.page_table)
        tt, tl, tcache = decode_step(
            tp, t_cfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos),
            torch.from_numpy(lengths), page_table=tk.page_table)
        _rel_close(tl.numpy()[0], np.asarray(jl)[0])
        assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])
        tok = tt.numpy().copy()
        pos, lengths = pos + 1, lengths + 1
    window = np.zeros((slots, w), np.int32)
    window[0, 0] = tok[0, 0]
    window[0, 1:] = rng.integers(0, t_cfg.vocab_size, w - 1)
    lengths[1] = 0
    for kc in (jk, tk):
        kc.ensure(0, int(pos[0]) + w)
    jg, jl, jcache = j_verify_step(jp, j_cfg, window, jcache, pos, lengths,
                                   page_table=jk.page_table)
    tg, tl, tcache = verify_step(
        tp, t_cfg, torch.from_numpy(window), tcache, torch.from_numpy(pos),
        torch.from_numpy(lengths), page_table=tk.page_table)
    _rel_close(tl.numpy()[0], np.asarray(jl)[0])
    np.testing.assert_array_equal(tg.numpy()[0], np.asarray(jg)[0])
    # The pages hold normed, rotated K: read slot 0's rows back.
    pages = tk.slot_pages(0)
    shape = (t_cfg.num_layers, -1, t_cfg.num_kv_heads, t_cfg.head_dim_)
    n = int(pos[0]) + w
    for name in ("k", "v"):
        got = tcache[name][:, pages].reshape(shape)[:, :n]
        want = np.asarray(jcache["blocks"][0][name])[:, pages]
        _rel_close(got.numpy(), want.reshape(shape)[:, :n])


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
def test_placed_prefill_then_decode_matches_reference(weights, fused):
    """qwen2-vl: prompts of 20 and 5 tokens prefilled whole and placed
    into slots 0 and 1 (slot 1 admitted after three steps, idle before),
    then 6 decode steps (M-RoPE with one position on all three axes)."""
    jp, tp = weights[VLM]
    j_cfg, t_cfg = _configs(VLM, fused)
    slots, max_len, ps = 2, 64, 16
    jk = JPagedKVCache(j_cfg, slots=slots, max_len=max_len, page_size=ps)
    tk = PagedKVCache(t_cfg, slots=slots, max_len=max_len, page_size=ps,
                      device="cpu")
    jcache, tcache = jk.init_cache(), tk.init_cache()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, t_cfg.vocab_size, n).astype(np.int32)
               for n in (20, 5)]
    tok = np.zeros((slots, 1), np.int32)
    pos = np.array([0, tk.extent], np.int32)
    lengths = np.zeros(slots, np.int32)

    def admit(slot):
        nonlocal jcache
        p = prompts[slot]
        pages = tk.ensure(slot, len(p))
        assert np.array_equal(jk.ensure(slot, len(p)), pages)
        jl, fresh = j_prefill(jp, j_cfg, {"tokens": jnp.asarray(p)[None]})
        jcache = jkv.place_prefill(jcache, fresh, jnp.int32(slot),
                                   jnp.asarray(pages),
                                   layout=j_cfg.kv_cache_layout)
        tl, tfresh = prefill(tp, t_cfg, torch.from_numpy(p)[None])
        tkv.place_prefill(tcache, tfresh, torch.from_numpy(pages),
                          layout=t_cfg.kv_cache_layout, slot=slot)
        _rel_close(tl.numpy(), jl)
        tok[slot, 0] = int(tl[0, 0].argmax())
        pos[slot] = lengths[slot] = len(p)

    admit(0)
    for step in range(6):
        if step == 3:
            admit(1)
        for s in range(slots):
            if lengths[s]:
                for kc in (jk, tk):
                    kc.ensure(s, int(pos[s]) + 1)
        jt, jl, jcache = j_decode_step(jp, j_cfg, tok, jcache, pos, lengths,
                                       page_table=jk.page_table)
        tt, tl, tcache = decode_step(
            tp, t_cfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos),
            torch.from_numpy(lengths), page_table=tk.page_table)
        live = lengths > 0
        _rel_close(tl.numpy()[live], np.asarray(jl)[live])
        np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])
        tok = tt.numpy().copy()
        pos = np.where(live, pos + 1, pos)
        lengths = np.where(live, lengths + 1, 0).astype(np.int32)
    tk.assert_page_accounting(tcache)
