"""The port's RWKV6 pieces (rwkv6-7b) on the CPU, against the JAX package.

* K14's plain version (``ref.wkv6``) against the interpret-mode Pallas
  ``wkv6_pallas`` and the reference's eager ``repro.models.layers.wkv6``
  (with ``init_state``) at S in {64, 128, 37}, batch 2, both outputs,
  float32, relative 1e-5 (max |d| over max |want|); with bfloat16 r/k/v
  and float32 w against the Pallas kernel at the card check's bf16
  tolerance (2e-2); the wrapper on a CPU tensor runs the plain version
  and launches nothing, and refuses a chunk that does not divide S.
* The eager ``wkv6``, ``token_shift`` and ``wkv6_chunked`` against
  ``repro.models.layers``, and ``fused_wkv6``'s gradients: the eager
  formulation's bit for bit, ``jax.vjp`` of the reference wrapper at 1e-5.
* On the card route the wrapper takes bf16 and f32 r/k/v with f32 w to
  the launch and refuses a bf16 decay, mixed r/k/v dtypes and a head
  size its build lacks.
* The config, the plan pinned to the reference compiler on H100
  (full and reduced, 1 to 4096 tokens, with and without ``w8``), the
  state-cache schema (wkv float32, the shifts bfloat16 under float32, no
  K/V pools), and the parameter bridge in both directions.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from test_torch_stream_plan import j_plan_for  # the reference on H100
from repro.kernels.rwkv6_wkv import wkv6_pallas
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.core.stream_plan import STAGES, plan_for
from repro_torch.kernels import _build, ref
from repro_torch.kernels import rwkv6_wkv as wkv_mod
from repro_torch.models import layers as L
from repro_torch.models import (init_params, model_defs, params_from_numpy,
                                params_to_numpy)
from repro_torch.models.params import (has_kv_pools, quantize_weights,
                                       state_cache_defs, tree_leaves)
from repro_torch.serving.kv_cache import PagedKVCache, paged_cache_defs


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
ARCH = "rwkv6-7b"


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _wkv_inputs(rng, b, s, h=4, n=16):
    """r, k, v, the decay w = exp(-exp(.)) in (0, 1), and the bonus u."""
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, n)) - 1.0)
               ).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    return r, k, v, w, u


# ------------------------------------------------------------------ K14

@pytest.mark.parametrize("s", [64, 128, 37])
def test_wkv6_plain_matches_pallas_and_eager_reference(s):
    rng = np.random.default_rng(s)
    args = _wkv_inputs(rng, 2, s)
    want_y, want_h = wkv6_pallas(*map(jnp.asarray, args), chunk=64,
                                 interpret=True)
    K.reset_launches()
    y, h = K.wkv6(*map(torch.from_numpy, args), chunk=64)
    assert K.wkv6.launches == 0                        # CPU: plain version
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _rel_close(y.numpy(), want_y)
    _rel_close(h.numpy(), want_h)
    init = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    want_y, want_h = JL.wkv6(*map(jnp.asarray, args),
                             init_state=jnp.asarray(init))
    y, h = ref.wkv6(*map(torch.from_numpy, args),
                    init_state=torch.from_numpy(init))
    _rel_close(y.numpy(), want_y)
    _rel_close(h.numpy(), want_h)


def test_wkv6_plain_matches_pallas_bf16():
    args = _wkv_inputs(np.random.default_rng(3), 2, 64)
    j_args = [jnp.asarray(a, jnp.bfloat16) for a in args[:3]] + [
        jnp.asarray(args[3]), jnp.asarray(args[4])]
    want_y, want_h = wkv6_pallas(*j_args, chunk=64, interpret=True)
    t_args = [torch.from_numpy(a).bfloat16() for a in args[:3]] + [
        torch.from_numpy(args[3]), torch.from_numpy(args[4])]
    y, h = ref.wkv6(*t_args)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _rel_close(y.float().numpy(), np.asarray(want_y.astype(jnp.float32)),
               2e-2)
    _rel_close(h.numpy(), want_h, 2e-2)


def test_wkv6_refuses_a_chunk_that_does_not_divide():
    args = [torch.from_numpy(a)
            for a in _wkv_inputs(np.random.default_rng(4), 1, 24)]
    with pytest.raises(ValueError, match="wkv6"):
        K.wkv6(*args, chunk=7)
    with pytest.raises(ValueError, match="wkv6"):
        K.wkv6(args[0], args[1][:, :20], *args[2:])


# ------------------------------------------------- eager RWKV6 layers

@pytest.mark.parametrize("with_prev", [False, True], ids=["zeros", "prev"])
def test_token_shift_matches_reference(with_prev):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    prev = rng.standard_normal((2, 1, 12)).astype(np.float32)
    want = JL.token_shift(jnp.asarray(x),
                          jnp.asarray(prev) if with_prev else None)
    got = L.token_shift(torch.from_numpy(x),
                        torch.from_numpy(prev) if with_prev else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s,chunk", [(64, 16), (37, 16), (48, 48)])
def test_wkv6_chunked_matches_reference(s, chunk):
    rng = np.random.default_rng(s + chunk)
    args = _wkv_inputs(rng, 2, s)
    init = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    want_y, want_h = JL.wkv6_chunked(*map(jnp.asarray, args),
                                     init_state=jnp.asarray(init),
                                     chunk=chunk)
    y, h = L.wkv6_chunked(*map(torch.from_numpy, args),
                          init_state=torch.from_numpy(init), chunk=chunk)
    _rel_close(y.numpy(), want_y)
    _rel_close(h.numpy(), want_h)


def test_eager_wkv6_one_step_matches_reference():
    rng = np.random.default_rng(6)
    args = _wkv_inputs(rng, 3, 1)
    init = rng.standard_normal((3, 4, 16, 16)).astype(np.float32)
    want_y, want_h = JL.wkv6(*map(jnp.asarray, args),
                             init_state=jnp.asarray(init))
    y, h = L.wkv6(*map(torch.from_numpy, args),
                  init_state=torch.from_numpy(init))
    _rel_close(y.numpy(), want_y)
    _rel_close(h.numpy(), want_h)


def test_fused_wkv6_grads_are_eager_grads_and_match_the_reference():
    rng = np.random.default_rng(8)
    args = _wkv_inputs(rng, 2, 24)
    t_in = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = L.fused_wkv6(*t_in, chunk=8)
    gy = rng.standard_normal(y.shape).astype(np.float32)
    gh = rng.standard_normal(h.shape).astype(np.float32)
    got = torch.autograd.grad((y, h), t_in,
                              (torch.from_numpy(gy), torch.from_numpy(gh)))
    e_in = [torch.from_numpy(a).requires_grad_(True) for a in args]
    want = torch.autograd.grad(L.wkv6(*e_in), e_in,
                               (torch.from_numpy(gy), torch.from_numpy(gh)))
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    (j_y, j_h), vjp = jax.vjp(
        lambda *a: JL.fused_wkv6(*a, chunk=8), *map(jnp.asarray, args))
    _rel_close(y.detach().numpy(), j_y)
    _rel_close(h.detach().numpy(), j_h)
    for a, w in zip(got, vjp((jnp.asarray(gy), jnp.asarray(gh)))):
        _rel_close(a.numpy(), w)
    with torch.no_grad():            # serving: the kernel alone, no node
        assert L.fused_wkv6(*t_in, chunk=8)[0].grad_fn is None


# --------------------------------------------------- the card route

class _Launched(Exception):
    """Raised in place of a kernel launch."""


def test_card_route_takes_bf16_and_f32_and_refuses_the_rest(monkeypatch):
    """Force the wrapper's kernel route for CPU tensors and stop at the
    launch: the C entry point raises ``_Launched``."""
    monkeypatch.setattr(wkv_mod, "kernel_path", lambda t: "cuda")

    def entry(dtype):
        def launch(*args):
            raise _Launched(dtype)
        return launch

    monkeypatch.setattr(wkv_mod, "_entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(
        f"reached the build of {name}"))
    r, k, v, w, u = (torch.from_numpy(a) for a in _wkv_inputs(
        np.random.default_rng(0), 1, 8, h=2, n=64))
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(_Launched, match=str(dt)):
            K.wkv6(r.to(dt), k.to(dt), v.to(dt), w, u.to(dt))
    with pytest.raises(TypeError, match="float32"):
        K.wkv6(*(t.bfloat16() for t in (r, k, v, w)), u)
    with pytest.raises(TypeError, match="share a dtype"):
        K.wkv6(r.bfloat16(), k, v, w, u)
    odd = [torch.from_numpy(a) for a in _wkv_inputs(
        np.random.default_rng(1), 1, 8, h=2, n=24)]
    with pytest.raises(ValueError, match="the CUDA kernel runs"):
        K.wkv6(*odd)
    assert K.wkv6.launches == 0


# ------------------------------------ config, plan, schema, parameters

def test_config_matches_reference():
    for j_cfg, t_cfg in ((j_get_config(ARCH), get_config(ARCH)),
                         (j_get_config(ARCH).reduced(),
                          get_config(ARCH).reduced())):
        assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
        assert t_cfg.rwkv_heads == j_cfg.rwkv_heads
    assert get_config(ARCH).rwkv_heads == 64
    assert get_config(ARCH).reduced().rwkv_heads == 4


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_plan_for_matches_reference(reduced):
    base, j_base = get_config(ARCH), j_get_config(ARCH)
    if reduced:
        base, j_base = base.reduced(), j_base.reduced()
    for quant in ("none", "w8"):
        cfg = dataclasses.replace(base, use_fused_kernels=True, quant=quant)
        j_cfg = dataclasses.replace(j_base, use_fused_kernels=True,
                                    quant=quant)
        for tokens in (1, 4, 37, 128, 1000, 4096):
            mine, want = plan_for(cfg, tokens), j_plan_for(j_cfg, tokens)
            assert [k for k, _ in mine.layers] == [k for k, _ in want.layers]
            lp, rlp = mine.layer("rwkv"), want.layer("rwkv")
            for stage in STAGES:
                got, exp = getattr(lp, stage), getattr(rlp, stage)
                assert (got.implementation, got.blocks) == (
                    exp.implementation, exp.blocks), (stage, tokens, quant)
            assert lp.mixer.implementation == "rwkv6_wkv"
            assert (mine.lm_head.implementation, mine.lm_head.blocks) == (
                want.lm_head.implementation, want.lm_head.blocks)


def test_state_cache_schema_has_no_kv_pools():
    cfg = get_config(ARCH)
    assert not has_kv_pools(cfg)
    defs = paged_cache_defs(cfg, 4, 2048, 16)
    assert sorted(defs) == ["cm_shift", "tm_shift", "wkv"]
    assert defs["wkv"].shape == (32, 4, 64, 64, 64)
    assert defs["wkv"].dtype == torch.float32
    assert defs["tm_shift"].shape == defs["cm_shift"].shape == (32, 4, 4096)
    # The shifts are bf16 whatever the compute dtype, as the reference's.
    f32 = dataclasses.replace(cfg.reduced(), dtype="float32")
    sd = state_cache_defs(f32, 2)
    assert sd["wkv"].dtype == torch.float32
    assert sd["tm_shift"].dtype == sd["cm_shift"].dtype == torch.bfloat16
    for dtype, size in (("float32", 4.0), ("bfloat16", 2.0)):
        kv = PagedKVCache(dataclasses.replace(f32, dtype=dtype), slots=2,
                          max_len=64, page_size=16, device="cpu")
        cache = kv.init_cache()
        assert sorted(cache) == ["cm_shift", "tm_shift", "wkv"]
        assert kv.kv_itemsize_effective == size and kv.page_bytes == 0
        kv.ensure(0, 20)
        kv.assert_page_accounting(cache)


def test_params_bridge_and_init_match_the_reference_schema():
    j_cfg = dataclasses.replace(j_get_config(ARCH).reduced(), dtype="float32")
    t_cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jp = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(1),
                                                j_cfg))
    defs = model_defs(t_cfg)
    assert "pos_embed" not in defs and "pos_embed" not in jp
    assert list(defs["layers"][0]) == ["ln1", "ln2", "tm", "cm"]
    assert list(defs["layers"][0]["tm"]) == [
        "mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "wr", "wk", "wv", "wg",
        "ww", "w_bias", "u", "wo"]
    assert list(defs["layers"][0]["cm"]) == ["mix_k", "mix_r", "wk", "wv",
                                             "wr"]
    tp = params_from_numpy(jp, t_cfg, device="cpu")
    assert len(tp["layers"]) == t_cfg.num_layers
    for i, layer in enumerate(tp["layers"]):
        for sub in ("tm", "cm"):
            for name, t in layer[sub].items():
                np.testing.assert_array_equal(
                    t.numpy(), jp["blocks"][0][sub][name][i])
    back = params_to_numpy(tp, t_cfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_back, flat_ref):
        np.testing.assert_array_equal(a, b)
    again = params_from_numpy(back, t_cfg, device="cpu")
    for a, b in zip(tree_leaves(again), tree_leaves(tp)):
        assert torch.equal(a, b)
    # The deterministic leaves draw what the reference's do.
    mine = init_params(t_cfg, torch.Generator().manual_seed(0),
                       device="cpu")
    for sub, name in (("tm", "w_bias"), ("tm", "u"), ("tm", "mix_w"),
                      ("cm", "mix_r")):
        _rel_close(mine["layers"][1][sub][name].numpy(),
                   jp["blocks"][0][sub][name][1], 1e-6)
    # No stage of an RWKV6 plan has an int8 twin: w8 keeps every weight.
    q_cfg = dataclasses.replace(t_cfg, use_fused_kernels=True, quant="w8")
    assert quantize_weights(q_cfg, tp)["layers"] == tp["layers"]
