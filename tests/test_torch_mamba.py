"""The port's Mamba2 pieces (zamba2) on the CPU, against the JAX package.

* K13's plain version (``ref.mamba2_ssd``) against the interpret-mode
  Pallas ``mamba2_ssd_pallas`` and the sequential oracle
  ``repro.kernels.ref.mamba2_ref`` at (S, Q) in {(5, 1), (24, 8), (37,
  37), (64, 64)}, batch 1 and 2, both outputs, float32, relative 1e-5
  (max |d| over max |want|); in bfloat16 against the Pallas kernel at the
  card check's bf16 tolerance (2e-2); the wrapper on a CPU tensor runs
  the plain version and launches nothing.
* The eager ``mamba2_ssd`` (with ``init_state``), ``mamba2_decode_step``
  and ``causal_conv1d`` against ``repro.models.layers``, and
  ``fused_mamba2_ssd``'s gradients: the eager formulation's bit for bit,
  ``jax.vjp`` of the reference wrapper at 1e-5.
* The cases the already ported kernels gain for zamba2: K4 / K10b with
  GELU and no folded norm, K1 / K9a and K7's static branch at head dim 80,
  each plain version against its Pallas kernel; on the card route the
  wrappers take them (and K13) to the launch and still refuse head dim 80
  for K2 and K8.
* The config, the plan pinned to the reference compiler on H100
  (both layer kinds and the loss, full and reduced, 4 to 2048 tokens,
  with and without ``w8_kv8``), the cache schema, and the parameter
  bridge with the ``shared`` block in both directions.
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
from repro.kernels import streamed_ffn as j_streamed_ffn
from repro.kernels.mamba2_scan import mamba2_ssd_pallas
from repro.kernels.ref import mamba2_ref
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.core.stream_plan import STAGES, plan_for
from repro_torch.kernels import _build, ref
from repro_torch.models import layers as L
from repro_torch.models import model_defs, params_from_numpy, params_to_numpy
from repro_torch.models.layers import quantize_channelwise
from repro_torch.models.params import (attn_pool_indices, quantize_weights,
                                       tree_leaves)
from repro_torch.serving.kv_cache import paged_cache_defs


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
ARCH = "zamba2-2.7b"


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _ssd_inputs(rng, b, s, h=4, p=32, n=16):
    """x, dt (softplus-ed, small), a_log (the init's), B, C, d_skip."""
    x = _rand(rng, b, s, h, p)
    dt = (0.1 * np.log1p(np.exp(rng.standard_normal((b, s, h))))
          ).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    return (x, dt, a_log, _rand(rng, b, s, n), _rand(rng, b, s, n),
            _rand(rng, h))


# ------------------------------------------------------------------ K13

SSD_CASES = [(5, 1), (24, 8), (37, 37), (64, 64)]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("s,q", SSD_CASES, ids=[f"S{s}Q{q}"
                                                for s, q in SSD_CASES])
def test_mamba2_scan_plain_matches_pallas_and_oracle(s, q, batch):
    args = _ssd_inputs(np.random.default_rng(10 * s + batch), batch, s)
    j_args = [jnp.asarray(a) for a in args]
    want_y, want_h = mamba2_ssd_pallas(*j_args, chunk=q, interpret=True)
    oracle_y, oracle_h = mamba2_ref(*j_args)
    K.reset_launches()
    y, h = K.mamba2_ssd(*(torch.from_numpy(a) for a in args), chunk=q)
    assert K.mamba2_ssd.launches == 0                  # CPU: plain version
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    for got, want in ((y, want_y), (h, want_h), (y, oracle_y),
                      (h, oracle_h)):
        _rel_close(got.numpy(), want)


def test_mamba2_scan_plain_matches_pallas_bf16():
    args = _ssd_inputs(np.random.default_rng(3), 2, 24)
    j_args = [jnp.asarray(a, jnp.bfloat16) for a in args]
    want_y, want_h = mamba2_ssd_pallas(*j_args, chunk=8, interpret=True)
    y, h = ref.mamba2_ssd(*(torch.from_numpy(np.asarray(a, np.float32))
                            .bfloat16() for a in j_args), chunk=8)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    _rel_close(y.float().numpy(), np.asarray(want_y.astype(jnp.float32)),
               2e-2)
    _rel_close(h.numpy(), want_h, 2e-2)


def test_mamba2_scan_refuses_a_chunk_that_does_not_divide():
    args = [torch.from_numpy(a)
            for a in _ssd_inputs(np.random.default_rng(4), 1, 24)]
    with pytest.raises(ValueError, match="mamba2_ssd"):
        K.mamba2_ssd(*args, chunk=7)
    with pytest.raises(ValueError, match="mamba2_ssd"):
        K.mamba2_ssd(args[0], args[1][:, :20], *args[2:], chunk=8)


# ------------------------------------------------- eager Mamba2 layers

@pytest.mark.parametrize("s,q", [(24, 8), (37, 37), (30, 10)])
def test_eager_mamba2_ssd_with_init_state_matches_reference(s, q):
    rng = np.random.default_rng(s)
    args = _ssd_inputs(rng, 2, s)
    init = _rand(rng, 2, 4, 32, 16)
    want_y, want_h = JL.mamba2_ssd(*map(jnp.asarray, args), chunk=q,
                                   init_state=jnp.asarray(init))
    y, h = L.mamba2_ssd(*map(torch.from_numpy, args), chunk=q,
                        init_state=torch.from_numpy(init))
    _rel_close(y.numpy(), want_y)
    _rel_close(h.numpy(), want_h)


def test_mamba2_decode_step_matches_reference():
    rng = np.random.default_rng(6)
    x, dt, a_log, b, c, d = _ssd_inputs(rng, 3, 1)
    state = _rand(rng, 3, 4, 32, 16)
    args = (x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0], d, state)
    want_y, want_h = JL.mamba2_decode_step(*map(jnp.asarray, args))
    y, h = L.mamba2_decode_step(*map(torch.from_numpy, args))
    _rel_close(y.numpy(), want_y)
    _rel_close(h.numpy(), want_h)


@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
def test_causal_conv1d_matches_reference(with_init):
    rng = np.random.default_rng(7)
    x, w, bias = _rand(rng, 2, 11, 24), _rand(rng, 4, 24), _rand(rng, 24)
    init = _rand(rng, 2, 3, 24) if with_init else None
    want_y, want_tail = JL.causal_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        None if init is None else jnp.asarray(init))
    y, tail = L.causal_conv1d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
        None if init is None else torch.from_numpy(init))
    _rel_close(y.numpy(), want_y)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(want_tail))


def test_fused_mamba2_ssd_grads_are_eager_grads_and_match_the_reference():
    rng = np.random.default_rng(8)
    args = _ssd_inputs(rng, 2, 24)
    t_in = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, h = L.fused_mamba2_ssd(*t_in, chunk=8)
    gy, gh = _rand(rng, *y.shape), _rand(rng, *h.shape)
    got = torch.autograd.grad((y, h), t_in,
                              (torch.from_numpy(gy), torch.from_numpy(gh)))
    e_in = [torch.from_numpy(a).requires_grad_(True) for a in args]
    want = torch.autograd.grad(L.mamba2_ssd(*e_in, chunk=8), e_in,
                               (torch.from_numpy(gy), torch.from_numpy(gh)))
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    (j_y, j_h), vjp = jax.vjp(
        lambda *a: JL.fused_mamba2_ssd(*a, chunk=8), *map(jnp.asarray, args))
    _rel_close(y.detach().numpy(), j_y)
    _rel_close(h.detach().numpy(), j_h)
    for a, w in zip(got, vjp((jnp.asarray(gy), jnp.asarray(gh)))):
        _rel_close(a.numpy(), w)
    with torch.no_grad():            # serving: the kernel alone, no node
        assert L.fused_mamba2_ssd(*t_in, chunk=8)[0].grad_fn is None


# ---------------------------------- the cases zamba2 adds to K1, K4, K7

@pytest.mark.parametrize("w8", [False, True], ids=["bf", "int8"])
@pytest.mark.parametrize("t", [4, 40])
def test_streamed_ffn_gelu_without_a_norm_matches_pallas(t, w8):
    rng = np.random.default_rng(11)
    d, f = 64, 256
    x = _rand(rng, t, d)
    ws = [_rand(rng, d, f, scale=d ** -0.5), _rand(rng, d, f, scale=d ** -0.5),
          _rand(rng, f, d, scale=f ** -0.5)]
    if not w8:
        got = K.streamed_ffn(*map(torch.from_numpy, [x] + ws),
                             activation="gelu")
        want = j_streamed_ffn(*map(jnp.asarray, [x] + ws), activation="gelu",
                              block_t=128, block_f=128)
        _rel_close(got.numpy(), want)
        return
    q = [quantize_channelwise(torch.from_numpy(w)) for w in ws]
    got = K.streamed_ffn_w8(x=torch.from_numpy(x), wg=q[0][0], wu=q[1][0],
                            wd=q[2][0], wg_scale=q[0][1], wu_scale=q[1][1],
                            wd_scale=q[2][1], activation="gelu")
    want = j_streamed_ffn(
        jnp.asarray(x), *(jnp.asarray(c.numpy()) for c, _ in q),
        activation="gelu", block_t=128, block_f=128,
        wg_scale=jnp.asarray(q[0][1].numpy()),
        wu_scale=jnp.asarray(q[1][1].numpy()),
        wd_scale=jnp.asarray(q[2][1].numpy()))
    _rel_close(got.numpy(), want)


@pytest.mark.parametrize("code", [None, "int8"])
def test_paged_decode_head_dim_80_matches_pallas(code):
    rng = np.random.default_rng(12)
    b, hq, hkv, d, ps, pages = 3, 4, 4, 80, 4, 10
    q = _rand(rng, b, 1, hq, d)
    kp, vp = _rand(rng, pages, ps, hkv, d), _rand(rng, pages, ps, hkv, d)
    table = np.array([[1, 2, 3], [4, 5, 0], [6, 7, 8]], np.int32)
    lengths = np.array([11, 5, 0], np.int32)
    sc = {}
    if code is not None:
        ks = (np.abs(kp).max(axis=(1, 3)) / 127).astype(np.float32)
        vs = (np.abs(vp).max(axis=(1, 3)) / 127).astype(np.float32)
        kp = np.round(kp / ks[:, None, :, None]).astype(np.int8)
        vp = np.round(vp / vs[:, None, :, None]).astype(np.int8)
        sc = dict(k_scale=ks, v_scale=vs)
    want = j_paged_decode(*map(jnp.asarray, (q, kp, vp, table, lengths)),
                          **{k: jnp.asarray(v) for k, v in sc.items()})
    targs = [torch.from_numpy(a) for a in (q, kp, vp, table, lengths)]
    tsc = {k: torch.from_numpy(v) for k, v in sc.items()}
    got = (K.paged_decode_attention_q(*targs, **tsc) if code
           else K.paged_decode_attention(*targs))
    _rel_close(got.numpy(), want)
    assert not got[2].any()                          # length 0: zeros


def test_flash_static_head_dim_80_matches_pallas():
    rng = np.random.default_rng(13)
    q, k, v = (_rand(rng, 4, 37, 80), _rand(rng, 2, 37, 80),
               _rand(rng, 2, 37, 80))
    got = K.flash_attention_2d(*map(torch.from_numpy, (q, k, v)), kv_group=2)
    want = j_flash_2d(*map(jnp.asarray, (q, k, v)), kv_group=2,
                      block_q=16, block_kv=16)
    _rel_close(got.numpy(), want)


class _Launched(Exception):
    """Raised in place of a kernel launch."""


def _card_route(monkeypatch):
    """Force every wrapper's kernel route for CPU tensors and stop at the
    launch: the C entry point raises ``_Launched``."""
    for mod in ("streamed_ffn", "paged_attention", "flash_attention",
                "mamba2_scan"):
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


def test_card_route_takes_the_zamba2_cases_and_refuses_the_rest(
        monkeypatch):
    _card_route(monkeypatch)
    x, wu, wd = torch.randn(4, 32), torch.randn(32, 16), torch.randn(16, 32)
    qd, pool = torch.randn(2, 1, 4, 80), torch.randn(5, 4, 2, 80)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([5, 0], dtype=torch.int32)
    q, kv = torch.randn(4, 8, 80), torch.randn(2, 8, 80)
    codes, scales = pool.to(torch.int8), torch.ones(5, 2)
    ssd = [torch.from_numpy(a)
           for a in _ssd_inputs(np.random.default_rng(0), 1, 8)]
    taken = {
        "ffn_gelu": lambda: K.streamed_ffn(x, wu, wu, wd,
                                           activation="gelu"),
        "ffn_w8_gelu": lambda: K.streamed_ffn_w8(
            x, *(w.to(torch.int8) for w in (wu, wu, wd)),
            wg_scale=torch.ones(16), wu_scale=torch.ones(16),
            wd_scale=torch.ones(32), activation="gelu"),
        "paged_80": lambda: K.paged_decode_attention(qd, pool, pool, table,
                                                     lengths),
        "paged_q_80": lambda: K.paged_decode_attention_q(
            qd, codes, codes, table, lengths, k_scale=scales,
            v_scale=scales),
        "static_80": lambda: K.flash_attention_2d(q, kv, kv, kv_group=2),
        "mamba2_scan": lambda: K.mamba2_ssd(*ssd, chunk=8),
        "mamba2_scan_q1": lambda: K.mamba2_ssd(*ssd, chunk=1),
        # GELU with the norm folded in over int8 weights: gemma3's K10b.
        "ffn_gelu_norm": lambda: K.streamed_ffn_w8(
            x, *(w.to(torch.int8) for w in (wu, wu, wd)),
            wg_scale=torch.ones(16), wu_scale=torch.ones(16),
            wd_scale=torch.ones(32), activation="gelu",
            norm_scale=torch.zeros(32)),
    }
    for name, call in taken.items():
        with pytest.raises(_Launched):
            call()
    refused = {
        "offset_80": lambda: K.flash_attention_2d(q, kv, kv, q_offset=0,
                                                  kv_group=2),
        "verify_80": lambda: K.paged_verify_attention(
            qd, pool, pool, table, lengths),
        "ffn_silu_no_norm": lambda: K.streamed_ffn(x, wu, wu, wd),
        "ffn_w8_silu_no_norm": lambda: K.streamed_ffn_w8(
            x, *(w.to(torch.int8) for w in (wu, wu, wd)),
            wg_scale=torch.ones(16), wu_scale=torch.ones(16),
            wd_scale=torch.ones(32)),
    }
    for name, call in refused.items():
        with pytest.raises(ValueError, match="the CUDA kernel runs"):
            call()


# ------------------------------------ config, plan, schema, parameters

def test_config_matches_reference():
    for j_cfg, t_cfg in ((j_get_config(ARCH), get_config(ARCH)),
                         (j_get_config(ARCH).reduced(),
                          get_config(ARCH).reduced())):
        assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)
        assert (t_cfg.d_inner, t_cfg.ssm_heads) == (j_cfg.d_inner,
                                                    j_cfg.ssm_heads)
    assert (get_config(ARCH).d_inner, get_config(ARCH).ssm_heads) == (5120,
                                                                      80)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_plan_for_matches_reference(reduced):
    base, j_base = get_config(ARCH), j_get_config(ARCH)
    if reduced:
        base, j_base = base.reduced(), j_base.reduced()
    for quant in ("none", "w8_kv8"):
        cfg = dataclasses.replace(base, use_fused_kernels=True, quant=quant)
        j_cfg = dataclasses.replace(j_base, use_fused_kernels=True,
                                    quant=quant)
        for tokens in (4, 20, 128, 2048):
            mine = plan_for(cfg, tokens, 2048)
            want = j_plan_for(j_cfg, tokens, 2048)
            assert [k for k, _ in mine.layers] == [k for k, _ in want.layers]
            for kind in ("mamba", "mamba+shared_attn"):
                lp, rlp = mine.layer(kind), want.layer(kind)
                for stage in STAGES:
                    got, exp = getattr(lp, stage), getattr(rlp, stage)
                    assert (got.implementation, got.blocks) == (
                        exp.implementation, exp.blocks), (kind, stage,
                                                          tokens, quant)
            assert (mine.lm_head.implementation, mine.lm_head.blocks) == (
                want.lm_head.implementation, want.lm_head.blocks)
            assert mine.decode_page_size() == want.decode_page_size()


def test_cache_schema_pools_only_the_shared_applications():
    cfg = get_config(ARCH)
    idx = attn_pool_indices(cfg)
    assert [i for i, a in enumerate(idx) if a is not None] == list(
        range(5, 54, 6))
    assert [a for a in idx if a is not None] == list(range(9))
    defs = paged_cache_defs(cfg, 4, 2048, 16)
    assert defs["k"].shape == (9, 1 + 4 * 128, 16, 32, 80)
    assert defs["ssm"].shape == (54, 4, 80, 64, 64)
    assert defs["ssm"].dtype == torch.float32
    assert defs["conv"].shape == (54, 4, 3, 5120)
    assert defs["conv"].dtype == torch.bfloat16
    q = paged_cache_defs(dataclasses.replace(cfg, quant="kv_int8"), 4,
                         2048, 16)
    assert q["k"].dtype == torch.int8 and q["k_scale"].shape == (9, 513, 32)
    assert q["ssm"] == defs["ssm"]


def test_params_bridge_carries_the_shared_block_both_ways():
    j_cfg = dataclasses.replace(j_get_config(ARCH).reduced(), dtype="float32")
    t_cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jp = jax.tree.map(np.asarray, j_init_params(jax.random.PRNGKey(1),
                                                j_cfg))
    defs = model_defs(t_cfg)
    assert list(defs["layers"][0]["mamba"]) == [
        "wx", "wz", "wb", "wc", "wdt", "dt_bias", "a_log", "d_skip",
        "conv_w", "conv_b", "wout"]
    assert set(defs["shared"]) == set(jp["shared"])
    tp = params_from_numpy(jp, t_cfg, device="cpu")
    assert len(tp["layers"]) == t_cfg.num_layers
    period = len(t_cfg.layer_pattern)
    for i, layer in enumerate(tp["layers"]):
        want = jp["blocks"][i % period]["mamba"]
        for name, t in layer["mamba"].items():
            np.testing.assert_array_equal(t.numpy(),
                                          want[name][i // period])
    for name, t in tp["shared"]["attn"].items():
        np.testing.assert_array_equal(t.numpy(), jp["shared"]["attn"][name])
    back = params_to_numpy(tp, t_cfg)
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (_, a), (_, b) in zip(flat_back, flat_ref):
        np.testing.assert_array_equal(a, b)
    again = params_from_numpy(back, t_cfg, device="cpu")
    for a, b in zip(tree_leaves(again), tree_leaves(tp)):
        assert torch.equal(a, b)
    # w8_kv8 quantizes the shared block's qkv and FFN, never the mixer.
    q_cfg = dataclasses.replace(t_cfg, use_fused_kernels=True,
                                quant="w8_kv8")
    qp = quantize_weights(q_cfg, tp)
    assert all(isinstance(qp["shared"]["attn"][n], tuple)
               for n in ("wq", "wk", "wv"))
    assert all(isinstance(qp["shared"]["mlp"][n], tuple)
               for n in ("wg", "wu", "wd"))
    assert not isinstance(qp["shared"]["attn"]["wo"], tuple)
    assert qp["layers"] == tp["layers"]
