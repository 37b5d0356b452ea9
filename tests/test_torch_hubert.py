"""hubert-xlarge in the port on the CPU, against the JAX package.

hubert is an encoder: 48 LayerNorm/MHA/GELU-MLP layers with non-causal
attention over frame embeddings (the stubbed feature extractor's output,
``batch["embeds"]``) plus a learned position table, and no token
embedding.  Its reduced config (2 layers, D 64, 4 heads of 16), float32.
Here:

* the config (full and reduced) equals the reference's field for field,
  and ``plan_for`` equals the reference's (gpt2's plan) at 128 and 2048
  tokens; other encoders stay refused;
* the parameter tree has no ``embed`` in either package, and the numpy
  bridge carries it both ways leaf for leaf;
* the static flash attention's plain version, non-causal, equals the
  Pallas kernel in interpret mode at head dims 16 and 80, S in {1, 37,
  64, 65, 200}, with kv_len = S and kv_len < S, GQA groups 1 and 2; a
  row of kv_len 0 gives zeros;
* ``forward_hidden`` over frame embeddings equals the reference's at
  relative 1e-5 on the kernel and the eager plan, remat on and off, the
  kernel plan calling ``block_matmul`` three times, ``streamed_mlp`` and
  the static flash attention (non-causal) once per layer;
* the CUDA entry points run non-causal attention as the causal walk with
  every query past the last key: the plain offset version there equals
  the non-causal static one bit for bit;
* the wrappers' card route takes non-causal static attention (its causal
  flag 0 to the entry point) and keeps refusing it on the offset branch,
  over codes and under a window.

Weights: the reference ``init_params`` jittered
(``repro.serving.accuracy.jitter_params``; the zero-initialised LayerNorm
scales would make every hidden state 0), then the numpy bridge.
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
from repro.models import forward_hidden as j_forward_hidden
from repro.models import init_params as j_init_params
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.core.stream_plan import plan_for
from repro_torch.kernels import _build
from repro_torch.models import (forward_hidden, init_params, model_defs,
                                params_from_numpy, params_to_numpy)
from repro_torch.models.params import tree_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "hubert-xlarge"
REL = 1e-5
B, S = 2, 24
# Each layer's kernel calls on the kernel plan: q, k and v through
# block_matmul (LayerNorm outside), the MLP through streamed_mlp, the
# attention through the static flash kernel (``K.flash_attention``).
LAYER_CALLS = {"block_matmul": 3, "streamed_mlp": 1, "flash_attention": 1}


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
                                 device="cpu", dtype=torch.float32)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------ config, plan, weights

def test_config_matches_reference():
    full, red = get_config(ARCH), get_config(ARCH).reduced()
    for j_cfg, t_cfg in ((j_get_config(ARCH), full),
                         (j_get_config(ARCH).reduced(), red)):
        assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
        assert t_cfg.head_dim_ == j_cfg.head_dim_
    assert (full.num_layers, full.d_model, full.head_dim_) == (48, 1280, 80)
    assert full.encoder_only and not full.causal
    assert full.frontend == "frame" and full.rope == "none"


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("tokens", [128, 2048])
def test_plan_for_matches_reference(reduced, tokens):
    base, j_base = get_config(ARCH), j_get_config(ARCH)
    gpt2 = get_config("gpt2")
    if reduced:
        base, j_base, gpt2 = base.reduced(), j_base.reduced(), gpt2.reduced()
    cfg = dataclasses.replace(base, use_fused_kernels=True)
    j_cfg = dataclasses.replace(j_base, use_fused_kernels=True)
    mine, ref = plan_for(cfg, tokens), j_plan_for(j_cfg, tokens)
    assert [k for k, _ in mine.layers] == [k for k, _ in ref.layers] \
        == ["attn"]
    gpt2_plan = plan_for(dataclasses.replace(gpt2, use_fused_kernels=True),
                         tokens).layer("attn")
    for stage in ("qkv", "attention", "ffn"):
        got = getattr(mine.layer("attn"), stage)
        want = getattr(ref.layer("attn"), stage)
        assert (got.implementation, got.blocks) == (want.implementation,
                                                    want.blocks), stage
        assert got == getattr(gpt2_plan, stage)
    assert (mine.lm_head.implementation, mine.lm_head.blocks) == (
        ref.lm_head.implementation, ref.lm_head.blocks)
    assert plan_for(base, tokens) is None          # eager config


def test_params_bridge_carries_the_tree_without_embed(weights):
    jp, tp = weights
    _, t_cfg = _configs(False)
    assert "embed" not in jp and "embed" not in tp
    assert list(model_defs(t_cfg)) == ["pos_embed", "layers", "final_norm",
                                       "lm_head"]
    fresh = init_params(t_cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    assert sorted(fresh) == sorted(tp)
    back = params_to_numpy(tp, t_cfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jp))[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_back, flat_ref):
        np.testing.assert_array_equal(a, b)
    again = params_from_numpy(back, t_cfg, device="cpu", dtype=torch.float32)
    for a, b in zip(tree_leaves(again), tree_leaves(tp)):
        assert torch.equal(a, b)
    # The fresh tree's leaves line up with the reference's, name for name
    # and shape for shape.
    fresh_flat = jax.tree_util.tree_flatten_with_path(
        params_to_numpy(fresh, t_cfg))[0]
    assert [(p, a.shape) for p, a in fresh_flat] == [
        (p, a.shape) for p, a in flat_ref]


# ---------------------------------------- the plain non-causal K7 version

# (head dim, S, kv_len below S): every S at kv_len = S, and below S where
# there is a positive kv_len below it (kv_len 0 has its own test).
FLASH_CASES = [(d, s, short) for d in (16, 80) for s in (1, 37, 64, 65, 200)
               for short in (False, True) if s > 1 or not short]


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("d,s,short", FLASH_CASES)
def test_plain_non_causal_flash_matches_pallas(d, s, short, group):
    rng = np.random.default_rng(d * 1000 + s)
    hkv = 2
    q = _rand(rng, hkv * group, s, d)
    k, v = _rand(rng, hkv, s, d), _rand(rng, hkv, s, d)
    kv_len = s - max(1, s // 3) if short else s
    got = K.flash_attention_2d(*(torch.from_numpy(a) for a in (q, k, v)),
                               kv_len=kv_len, causal=False, kv_group=group,
                               block_kv=32)
    want = j_flash_2d(*(jnp.asarray(a) for a in (q, k, v)), kv_len=kv_len,
                      causal=False, kv_group=group, block_q=32, block_kv=32)
    _rel_close(got.numpy(), np.asarray(want))
    if short:       # the keys past kv_len are not read
        k[:, kv_len:] = 1e4
        again = K.flash_attention_2d(
            *(torch.from_numpy(a) for a in (q, k, v)), kv_len=kv_len,
            causal=False, kv_group=group, block_kv=32)
        assert torch.equal(again, got)


@pytest.mark.parametrize("s,kv_len", [(1, 1), (37, 37), (65, 40), (200, 129)])
def test_non_causal_is_causal_with_every_query_past_the_keys(s, kv_len):
    """The CUDA entry points run non-causal attention as the causal walk
    with every query at position Skv (past the last key): the offset
    branch's plain version there equals the non-causal static one, bit
    for bit."""
    rng = np.random.default_rng(s)
    q = torch.from_numpy(_rand(rng, 4, s, 16))
    k, v = (torch.from_numpy(_rand(rng, 2, s, 16)) for _ in range(2))
    non_causal = K.flash_attention_2d(q, k, v, kv_len=kv_len, causal=False,
                                      kv_group=2, block_kv=32)
    past = K.flash_attention_2d(q, k, v, q_offset=s, kv_len=kv_len,
                                kv_group=2, block_kv=32)
    assert torch.equal(non_causal, past)


def test_plain_non_causal_flash_gives_zero_rows_at_kv_len_0():
    rng = np.random.default_rng(5)
    q, k, v = (_rand(rng, 2, 37, 16) for _ in range(3))
    got = K.flash_attention_2d(*(torch.from_numpy(a) for a in (q, k, v)),
                               kv_len=0, causal=False)
    want = j_flash_2d(*(jnp.asarray(a) for a in (q, k, v)), kv_len=0,
                      causal=False, block_q=32, block_kv=32)
    assert not got.abs().max() and not np.abs(np.asarray(want)).max()


# ------------------------------------------------------- the encoder

def _count_calls(monkeypatch, names):
    """Count calls of the kernel wrappers the model layers reach (plain
    versions on the CPU, so their launch counters stay at 0)."""
    calls = dict.fromkeys(names, 0)
    for n in names:
        fn = getattr(K, n)

        def counted(*a, _n=n, _fn=fn, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(K, n, counted)
    return calls


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
def test_forward_hidden_over_frames_matches_reference(weights, fused, remat,
                                                      monkeypatch):
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    embeds = _rand(np.random.default_rng(11), B, S, t_cfg.d_model)
    want = j_forward_hidden(jp, j_cfg, {"embeds": jnp.asarray(embeds)},
                            remat=remat)
    seen = []
    flash = K.flash_attention

    def flash_spy(*a, **kw):
        seen.append(kw.get("causal"))
        return flash(*a, **kw)

    monkeypatch.setattr(K, "flash_attention", flash_spy)
    calls = _count_calls(monkeypatch, list(LAYER_CALLS))
    with torch.no_grad():
        got = forward_hidden(tp, t_cfg, {"embeds": torch.from_numpy(embeds)},
                             remat=remat)
    _rel_close(got.numpy(), np.asarray(want))
    n = t_cfg.num_layers if fused else 0
    assert seen == [False] * n
    assert calls == {k: c * n for k, c in LAYER_CALLS.items()}
    # Not causal: a later frame moves an earlier frame's hidden state.
    moved = embeds.copy()
    moved[:, -1] += 1.0
    with torch.no_grad():
        other = forward_hidden(tp, t_cfg,
                               {"embeds": torch.from_numpy(moved)},
                               remat=remat)
    assert not torch.equal(other[:, 0], got[:, 0])


# ------------------------------------------------------------ card route

class _FakeLib:
    """A built library stand-in: each entry point records its symbol and
    arguments and returns 0 (cudaSuccess)."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, symbol):
        def entry(*args):
            self.calls.append((self.name, symbol, args))
            return 0
        return entry


@pytest.fixture
def card_route(monkeypatch):
    """The flash wrappers' CUDA route forced for CPU tensors, every
    library a ``_FakeLib``; returns the recorded launches."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    calls = []
    monkeypatch.setattr(fa, "kernel_path", lambda t: "cuda")
    fa._entry.cache_clear()
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(name, calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    yield calls
    fa._entry.cache_clear()


@pytest.mark.parametrize("dtype,lib,symbol", [
    (torch.bfloat16, "flash_mma", "repro_flash_static_mma_bf16"),
    (torch.float32, "flash_attention", "repro_flash_static_f32")])
@pytest.mark.parametrize("causal", [False, True])
def test_card_route_passes_the_causal_flag(card_route, dtype, lib, symbol,
                                           causal):
    q = torch.randn(32, 40, 80).to(dtype)
    kv = torch.randn(16, 40, 80).to(dtype)
    before = K.flash_attention_static.launches
    K.flash_attention_2d(q, kv, kv, kv_len=33, kv_group=2, causal=causal)
    (got_lib, got_symbol, args), = card_route
    assert (got_lib, got_symbol) == (lib, symbol)
    # (hq, sq, skv, d, kv_group, kv_len, window, causal, scale, stream)
    assert args[4:12] == (32, 40, 40, 80, 2, 33, 0, int(causal))
    assert K.flash_attention_static.launches == before + 1


def test_card_route_refuses_non_causal_elsewhere(card_route):
    q, kv = torch.randn(4, 8, 64), torch.randn(2, 16, 64)
    codes, sc = kv.to(torch.int8), torch.ones(2, 16)
    refused = {
        "static under a window": lambda: K.flash_attention_2d(
            q, kv, kv, kv_group=2, window=4, causal=False),
        "offset (K2)": lambda: K.flash_attention_2d(
            q, kv, kv, q_offset=8, kv_group=2, causal=False),
        "offset over codes (K9c)": lambda: K.flash_attention_2d_q(
            q, codes, codes, k_scale=sc, v_scale=sc, q_offset=8,
            kv_group=2, causal=False),
    }
    for name, call in refused.items():
        with pytest.raises(ValueError, match="the CUDA kernel runs"):
            call()
    assert card_route == []
