"""gemma3-4b in the port on the CPU, against the JAX package.

gemma3 interleaves five sliding-window (``local_attn``) layers with one
global (``global_attn``) layer, at head dim 320, with qk-norm, a GELU-GLU
and a tied 262144-token vocabulary.  Its reduced config keeps the pattern
(window 32, a global layer every 2, head dim 16).  Here:

* the config (full and reduced) equals the reference's, and ``plan_for``
  is pinned to the reference's for both kinds at serving and training
  token counts;
* the weights carry the q/k norm scales, the embedding and the LM head
  both ways;
* ``local_attention`` equals the reference's;
* ``prefill``, ``prefill_chunk``, ``decode_step`` and ``verify_step``
  logits at relative 1e-5 on both plans, past the window;
* the plain flash (static and offset), paged-decode and paged-verify
  versions at head dim 320 under a window of 64 against the Pallas kernels
  in interpret mode, at lengths window - 1, window, window + 1 and 200,
  and the GELU-GLU with the norm folded in against the Pallas FFN;
* on the card route (a stand-in entry point), the wrappers take gemma3's
  cases: K7/K2 and K1/K8 with a window at head dim 320, K4 GELU with the
  norm folded in, and their quantized twins (K9c, K9a / K9b over code
  pools with a window at head dim 320, K10b GELU with the norm folded
  in); K9c keeps refusing non-causal attention and head dim 80.

Weights: the reference ``init_params`` jittered
(``repro.serving.accuracy.jitter_params``), then the numpy bridge: the q/k
norm scales start at zero.  Float32 on both sides.
"""

import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from test_torch_stream_plan import j_plan_for  # the reference on H100
from repro.kernels import flash_attention_2d as j_flash_2d
from repro.kernels import paged_decode_attention as j_paged_decode
from repro.kernels import paged_verify_attention as j_paged_verify
from repro.kernels import streamed_ffn as j_streamed_ffn
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import prefill as j_prefill
from repro.models import prefill_chunk as j_prefill_chunk
from repro.models import verify_step as j_verify_step
from repro.serving import PagedKVCache as JPagedKVCache
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.core.stream_plan import STAGES, plan_for
from repro_torch.kernels import _build
from repro_torch.models import (decode_step, layers as L, model_defs,
                                params_from_numpy, params_to_numpy, prefill,
                                prefill_chunk, verify_step)
from repro_torch.models.params import tree_leaves
from repro_torch.serving import PagedKVCache
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


ARCH = "gemma3-4b"
REL = 1e-5
KINDS = ("local_attn", "global_attn")


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _configs(fused: bool):
    j_cfg = dataclasses.replace(j_get_config(ARCH).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                                use_fused_kernels=fused)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def weights():
    j_cfg, t_cfg = _configs(False)
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(0), j_cfg), seed=3)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                                 device="cpu")


def _ref_layers(blocks, get, n):
    """The reference keeps one stacked tree per kind of the layer pattern
    (``blocks[j]``, j = i mod period): layer i's leaf, in the port's layer
    order, stacked."""
    period = len(blocks)
    return np.stack([np.asarray(get(blocks[i % period]))[i // period]
                     for i in range(n)])


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------ config, plan, weights

def test_config_matches_reference():
    full, red = get_config(ARCH), get_config(ARCH).reduced()
    for j_cfg, t_cfg in ((j_get_config(ARCH), full),
                         (j_get_config(ARCH).reduced(), red)):
        assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
        assert t_cfg.head_dim_ == j_cfg.head_dim_
    # The reference's head dim: d_model / heads (the published config has
    # 256; the port computes what the reference computes).
    assert full.head_dim_ == 320 and red.head_dim_ == 16
    assert [full.layer_kind(i) for i in range(6)] == ["local_attn"] * 5 + [
        "global_attn"]
    assert [red.layer_kind(i) for i in range(4)] == [
        "local_attn", "global_attn"] * 2


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_plan_for_matches_reference(reduced):
    base, j_base = get_config(ARCH), j_get_config(ARCH)
    llama = get_config("llama3-8b")
    if reduced:
        base, j_base, llama = base.reduced(), j_base.reduced(), \
            llama.reduced()
    cfg = dataclasses.replace(base, use_fused_kernels=True)
    j_cfg = dataclasses.replace(j_base, use_fused_kernels=True)
    dense = plan_for(dataclasses.replace(llama, use_fused_kernels=True),
                     4, 256).layer("attn")
    for tokens, kv_len in ((1, 256), (4, 256), (20, 2048), (128, 2048),
                           (2048, 4096)):
        mine, ref = plan_for(cfg, tokens, kv_len), j_plan_for(j_cfg, tokens,
                                                              kv_len)
        assert [k for k, _ in mine.layers] == [k for k, _ in ref.layers] \
            == list(KINDS)
        for kind, lp in mine.layers:
            assert lp.kind == kind
            for stage in STAGES:
                got, want = getattr(lp, stage), getattr(ref.layer(kind),
                                                        stage)
                if stage in ("decode_attn", "verify_attn"):
                    # The page size is the engine's (``decode_page_size``).
                    assert got.implementation == want.implementation
                    continue
                assert (got.implementation, got.blocks) == (
                    want.implementation, want.blocks), (stage, tokens)
                assert got == getattr(dense, stage)
            assert dict(lp.ffn.blocks)["fuse_norm"] == 1
        if tokens in (4, 20, 128):       # the page sizes the port keeps
            ps = mine.decode_page_size()
            assert ps == ref.decode_page_size()
            assert mine.prefill_chunk_size(ps) == ref.prefill_chunk_size(ps)
            for draft_len in (1, 4, 20):
                assert (mine.verify_window(draft_len)
                        == ref.verify_window(draft_len))
    for tokens in (64, 512, 4096):
        mine, ref = plan_for(cfg, tokens), j_plan_for(j_cfg, tokens)
        for kind in KINDS:
            for stage in ("qkv", "attention", "ffn"):
                got = getattr(mine.layer(kind), stage)
                want = getattr(ref.layer(kind), stage)
                assert (got.implementation, got.blocks) == (
                    want.implementation, want.blocks), (stage, tokens)
        assert (mine.lm_head.implementation, mine.lm_head.blocks) == (
            ref.lm_head.implementation, ref.lm_head.blocks)
    assert plan_for(base, 4, 256) is None          # eager config


def test_params_bridge_carries_gemma_leaves_both_ways(weights):
    jp, tp = weights
    _, t_cfg = _configs(False)
    defs = model_defs(t_cfg)
    attn = defs["layers"][0]["attn"]
    assert list(attn) == ["wq", "wk", "wv", "wo", "q_norm", "k_norm"]
    assert all(attn[n].shape == (t_cfg.head_dim_,) for n in ("q_norm",
                                                             "k_norm"))
    n = t_cfg.num_layers
    for name in ("q_norm", "k_norm"):
        got = np.stack([layer["attn"][name].numpy()
                        for layer in tp["layers"]])
        np.testing.assert_array_equal(
            got, _ref_layers(jp["blocks"], lambda b: b["attn"][name], n))
        assert (np.abs(got).max(axis=1) > 0).all()   # jittered, not zero
    # ``tie_embeddings`` is not read by the reference's tree: the embedding
    # and the LM head are leaves of their own, carried as they are.
    vp = tp["lm_head"].shape[1]
    assert tuple(tp["embed"].shape) == (vp, t_cfg.d_model)
    assert vp >= t_cfg.vocab_size
    np.testing.assert_array_equal(tp["lm_head"].numpy(),
                                  np.asarray(jp["lm_head"]))
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


@pytest.mark.parametrize("s,window", [(40, 32), (300, 32), (200, 128),
                                      (50, 1024)])
def test_local_attention_matches_reference(s, window):
    rng = np.random.default_rng(s)
    q, k, v = _rand(rng, 2, s, 4, 16), _rand(rng, 2, s, 2, 16), \
        _rand(rng, 2, s, 2, 16)
    want = JL.local_attention(*(jnp.asarray(a) for a in (q, k, v)),
                              window=window)
    got = L.local_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            window=window)
    _rel_close(got.numpy(), want)


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
def test_prefill_matches_reference(weights, fused):
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    tokens = np.random.default_rng(3).integers(
        0, t_cfg.vocab_size, (2, 80)).astype(np.int32)
    jl, jc = j_prefill(jp, j_cfg, {"tokens": jnp.asarray(tokens)})
    tl, tc = prefill(tp, t_cfg, torch.from_numpy(tokens))
    _rel_close(tl.numpy(), jl)
    for name in ("k", "v"):
        _rel_close(tc[name].numpy(), _ref_layers(
            jc["blocks"], lambda b: b[name], t_cfg.num_layers))


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
def test_chunk_decode_and_verify_match_reference(weights, fused):
    """Two prefill chunks of a 100-token prompt (past the 32-token window)
    into slot 0, two decode steps with slot 1 idle, then a 5-row verify
    window."""
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
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


# ------------------------------------- plain kernel versions at D = 320

D, WINDOW = 320, 64
LENGTHS = (WINDOW - 1, WINDOW, WINDOW + 1, 200)


@pytest.mark.parametrize("s", LENGTHS)
def test_flash_static_with_a_window_at_head_dim_320_matches_pallas(s):
    rng = np.random.default_rng(s)
    q, k, v = (_rand(rng, 4, s, D, scale=0.3), _rand(rng, 2, s, D),
               _rand(rng, 2, s, D))
    got = K.flash_attention_2d(*(torch.from_numpy(a) for a in (q, k, v)),
                               window=WINDOW, kv_group=2, block_kv=32)
    want = j_flash_2d(*(jnp.asarray(a) for a in (q, k, v)), window=WINDOW,
                      kv_group=2, block_q=32, block_kv=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kv_len", LENGTHS)
def test_flash_offset_with_a_window_at_head_dim_320_matches_pallas(kv_len):
    """A 16-row chunk ending at ``kv_len``, over 256 cached positions."""
    rng = np.random.default_rng(kv_len + 1)
    sq, skv = 16, 256
    q, k, v = (_rand(rng, 4, sq, D, scale=0.3), _rand(rng, 2, skv, D),
               _rand(rng, 2, skv, D))
    q_off = kv_len - sq
    got = K.flash_attention_2d(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_offset=q_off, kv_len=kv_len, window=WINDOW,
                               kv_group=2, block_kv=32)
    want = j_flash_2d(*(jnp.asarray(a) for a in (q, k, v)), q_offset=q_off,
                      kv_len=kv_len, window=WINDOW, kv_group=2, block_q=16,
                      block_kv=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _pools(rng, b, hkv, ps=16, maxp=16):
    pages = 1 + b * maxp
    kp, vp = _rand(rng, pages, ps, hkv, D), _rand(rng, pages, ps, hkv, D)
    table = (rng.permutation(pages - 1) + 1).reshape(b, maxp).astype(
        np.int32)
    return kp, vp, table


@pytest.mark.parametrize("window", [WINDOW, 0])
def test_paged_decode_at_head_dim_320_matches_pallas(window):
    rng = np.random.default_rng(20)
    b, hq, hkv = len(LENGTHS) + 1, 8, 4
    kp, vp, table = _pools(rng, b, hkv)
    lengths = np.array(LENGTHS + (0,), np.int32)     # the last slot idle
    q = _rand(rng, b, 1, hq, D, scale=0.3)
    got = K.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, lengths)),
        window=window)
    want = j_paged_decode(*(jnp.asarray(a)
                            for a in (q, kp, vp, table, lengths)),
                          window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.count_nonzero(got[-1]) == 0


@pytest.mark.parametrize("window", [WINDOW, 0])
def test_paged_verify_at_head_dim_320_matches_pallas_and_decode(window):
    """Five rows per slot whose lengths cross the window's edge; each row
    equals the decode plain version at its own length."""
    rng = np.random.default_rng(21)
    b, w, hq, hkv = len(LENGTHS), 5, 8, 4
    kp, vp, table = _pools(rng, b, hkv)
    q_off = np.array([n - 3 for n in LENGTHS], np.int32)
    q = _rand(rng, b, w, hq, D, scale=0.3)
    ops = [torch.from_numpy(a) for a in (q, kp, vp, table, q_off)]
    got = K.paged_verify_attention(*ops, window=window)
    want = j_paged_verify(*(jnp.asarray(a) for a in (q, kp, vp, table,
                                                     q_off)),
                          window=window, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for i in range(w):
        row = K.paged_decode_attention(
            ops[0][:, i:i + 1].contiguous(), *ops[1:4],
            torch.from_numpy(q_off + i + 1), window=window)
        torch.testing.assert_close(got[:, i:i + 1], row, rtol=0, atol=0)


@pytest.mark.parametrize("t", [4, 20])
def test_streamed_ffn_gelu_with_the_norm_folded_in_matches_pallas(t):
    rng = np.random.default_rng(t)
    d, f = 64, 256
    x = _rand(rng, t, d)
    wg, wu = _rand(rng, d, f, scale=d ** -0.5), _rand(rng, d, f,
                                                      scale=d ** -0.5)
    wd, s = _rand(rng, f, d, scale=f ** -0.5), _rand(rng, d, scale=0.1)
    got = K.streamed_ffn(*(torch.from_numpy(a) for a in (x, wg, wu, wd)),
                         activation="gelu", norm_scale=torch.from_numpy(s))
    want = j_streamed_ffn(*(jnp.asarray(a) for a in (x, wg, wu, wd)),
                          activation="gelu", norm_scale=jnp.asarray(s),
                          block_t=128, block_f=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ card route

class _Launched(Exception):
    pass


def test_card_route_takes_the_gemma3_cases_and_refuses_the_rest(
        monkeypatch):
    """The wrappers' CUDA route (forced for CPU tensors, the entry point a
    stand-in that raises ``_Launched``) takes gemma3's cases, over codes
    and int8 weights too, and refuses the rest."""
    for mod in ("streamed_ffn", "paged_attention", "flash_attention"):
        w = importlib.import_module(f"repro_torch.kernels.{mod}")
        monkeypatch.setattr(w, "kernel_path", lambda t: "cuda")

        def entry(*a, **kw):
            def launch(*args):
                raise _Launched
            return launch

        monkeypatch.setattr(w, "_entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(
        f"reached the build of {name}"))
    x, wu, wd = torch.randn(4, 32), torch.randn(32, 16), torch.randn(16, 32)
    q, kv = torch.randn(8, 40, D), torch.randn(4, 40, D)
    pool = torch.randn(5, 4, 4, D)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    base = torch.tensor([5, 0], dtype=torch.int32)
    codes, pscale = pool.to(torch.int8), torch.ones(5, 4)
    taken = {
        "ffn_gelu_norm": lambda: K.streamed_ffn(
            x, wu, wu, wd, activation="gelu", norm_scale=torch.zeros(32)),
        "static_320_window": lambda: K.flash_attention_2d(
            q, kv, kv, kv_group=2, window=16),
        "offset_320_window": lambda: K.flash_attention_2d(
            q, kv, kv, q_offset=8, kv_group=2, window=16),
        "decode_320_window": lambda: K.paged_decode_attention(
            torch.randn(2, 1, 8, D), pool, pool, table, base, window=3),
        "verify_320_window": lambda: K.paged_verify_attention(
            torch.randn(2, 5, 8, D), pool, pool, table, base, window=3),
        "verify_320_16_rows": lambda: K.paged_verify_attention(
            torch.randn(2, 16, 8, D), pool, pool, table, base),
        "offset_q_window": lambda: K.flash_attention_2d_q(
            q[..., :128].contiguous(), kv[..., :128].to(torch.int8),
            kv[..., :128].to(torch.int8), k_scale=torch.ones(4, 40),
            v_scale=torch.ones(4, 40), q_offset=8, kv_group=2, window=16),
        "offset_q_320": lambda: K.flash_attention_2d_q(
            q, kv.to(torch.int8), kv.to(torch.int8),
            k_scale=torch.ones(4, 40), v_scale=torch.ones(4, 40),
            q_offset=8, kv_group=2, window=16),
        "decode_q_320": lambda: K.paged_decode_attention_q(
            torch.randn(2, 1, 8, D), codes, codes, table, base,
            k_scale=pscale, v_scale=pscale, window=3),
        "verify_q_320_window": lambda: K.paged_verify_attention_q(
            torch.randn(2, 5, 8, D), codes.to(torch.float8_e4m3fn),
            codes.to(torch.float8_e4m3fn), table, base, k_scale=pscale,
            v_scale=pscale, window=3),
        "ffn_w8_gelu_norm": lambda: K.streamed_ffn_w8(
            x, *(w.to(torch.int8) for w in (wu, wu, wd)),
            wg_scale=torch.ones(16), wu_scale=torch.ones(16),
            wd_scale=torch.ones(32), activation="gelu",
            norm_scale=torch.zeros(32)),
    }
    for name, call in taken.items():
        with pytest.raises(_Launched):
            call()
    refused = {
        "verify_320_17_rows": lambda: K.paged_verify_attention(
            torch.randn(2, 17, 8, D), pool, pool, table, base),
        "offset_q_non_causal": lambda: K.flash_attention_2d_q(
            q, kv.to(torch.int8), kv.to(torch.int8),
            k_scale=torch.ones(4, 40), v_scale=torch.ones(4, 40),
            q_offset=8, kv_group=2, causal=False),
        "offset_q_80": lambda: K.flash_attention_2d_q(
            q[..., :80].contiguous(), kv[..., :80].to(torch.int8),
            kv[..., :80].to(torch.int8), k_scale=torch.ones(4, 40),
            v_scale=torch.ones(4, 40), q_offset=8, kv_group=2, window=16),
    }
    for name, call in refused.items():
        with pytest.raises(ValueError, match="the CUDA kernel runs"):
            call()
