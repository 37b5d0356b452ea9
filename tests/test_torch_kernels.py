"""The port's kernels on the CPU: each plain PyTorch version against the
reference Pallas kernel (interpret mode, the reference's CPU default) on
the same numpy-seeded float32 inputs, at rtol = atol = 1e-5.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.  Here the wrappers must take the
plain path for a CPU tensor, count no launch, and refuse other devices.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import block_matmul as j_block_matmul
from repro.kernels import flash_attention as j_flash
from repro.kernels import flash_attention_2d as j_flash_2d
from repro.kernels import paged_decode_attention as j_paged
from repro.kernels import rmsnorm_matmul as j_rmsnorm_matmul
from repro.kernels import streamed_ffn as j_streamed_ffn
from repro.kernels import streamed_mlp as j_streamed_mlp
from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.common import pick_block, resolve_device

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


@pytest.mark.parametrize("t,d,n", [(24, 64, 48), (4, 128, 96), (130, 32, 16)])
def test_rmsnorm_matmul_matches_pallas(t, d, n):
    rng = np.random.default_rng(0)
    x, s, w = _rand(rng, t, d), _rand(rng, d, scale=0.1), \
        _rand(rng, d, n, scale=d ** -0.5)
    got = K.rmsnorm_matmul(torch.from_numpy(x), torch.from_numpy(s),
                           torch.from_numpy(w))
    want = j_rmsnorm_matmul(jnp.asarray(x), jnp.asarray(s), jnp.asarray(w),
                            block_t=128, block_n=128)
    _close(got, want)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
@pytest.mark.parametrize("fold_norm", [True, False])
@pytest.mark.parametrize("t", [4, 40])
def test_streamed_ffn_matches_pallas(activation, fold_norm, t):
    rng = np.random.default_rng(1)
    d, f = 64, 256
    x = _rand(rng, t, d)
    wg, wu = _rand(rng, d, f, scale=d ** -0.5), _rand(rng, d, f,
                                                      scale=d ** -0.5)
    wd = _rand(rng, f, d, scale=f ** -0.5)
    s = _rand(rng, d, scale=0.1) if fold_norm else None
    got = K.streamed_ffn(*(torch.from_numpy(a) for a in (x, wg, wu, wd)),
                         activation=activation,
                         norm_scale=None if s is None else torch.from_numpy(s))
    want = j_streamed_ffn(*(jnp.asarray(a) for a in (x, wg, wu, wd)),
                          activation=activation,
                          norm_scale=None if s is None else jnp.asarray(s),
                          block_t=128, block_f=128)
    _close(got, want)


@pytest.mark.parametrize("m,k,n", [(128, 64, 64), (4, 64, 192), (37, 96, 32),
                                   (130, 256, 48)])
def test_block_matmul_matches_pallas(m, k, n):
    rng = np.random.default_rng(6)
    x, w = _rand(rng, m, k), _rand(rng, k, n, scale=k ** -0.5)
    got = K.block_matmul(torch.from_numpy(x), torch.from_numpy(w))
    want = j_block_matmul(jnp.asarray(x), jnp.asarray(w), block_m=128,
                          block_n=128)
    _close(got, want)


@pytest.mark.parametrize("activation", ["gelu", "silu"])
@pytest.mark.parametrize("fold_norm", [False, True])
@pytest.mark.parametrize("t", [4, 40])
def test_streamed_mlp_matches_pallas(activation, fold_norm, t):
    rng = np.random.default_rng(7)
    d, f = 64, 256
    x = _rand(rng, t, d)
    wu = _rand(rng, d, f, scale=d ** -0.5)
    wd = _rand(rng, f, d, scale=f ** -0.5)
    s = _rand(rng, d, scale=0.1) if fold_norm else None
    got = K.streamed_mlp(*(torch.from_numpy(a) for a in (x, wu, wd)),
                         activation=activation,
                         norm_scale=None if s is None else torch.from_numpy(s))
    want = j_streamed_mlp(*(jnp.asarray(a) for a in (x, wu, wd)),
                          activation=activation,
                          norm_scale=None if s is None else jnp.asarray(s),
                          block_t=128, block_f=128)
    _close(got, want)


def test_streamed_mlp_rounds_h_to_the_input_dtype():
    """The Pallas body rounds ``act(x @ Wu)`` to x's dtype before the down
    product (``streamed_ffn.py:194-198``), which ``ref.mlp_ref`` does not:
    in bfloat16 the plain version must differ from an unrounded chain."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_rand(rng, 8, 64)).bfloat16()
    wu = torch.from_numpy(_rand(rng, 64, 256, scale=0.125)).bfloat16()
    wd = torch.from_numpy(_rand(rng, 256, 64, scale=0.0625)).bfloat16()
    got = K.streamed_mlp(x, wu, wd)
    h32 = torch.nn.functional.gelu(x.float() @ wu.float(), approximate="tanh")
    rounded = (h32.bfloat16().float() @ wd.float()).bfloat16()
    unrounded = (h32 @ wd.float()).bfloat16()
    assert torch.equal(got, rounded)
    assert not torch.equal(got, unrounded)


# (heads q, heads kv, S, kv_len, causal, window, head dim): MHA and GQA,
# causal and not, a sliding window, kv_len < S, a prompt length no tile
# divides, the gpt2 head dim.
FLASH_STATIC_CASES = [
    (4, 4, 64, 64, True, 0, 16),
    (4, 2, 64, 64, True, 0, 16),
    (4, 2, 48, 48, False, 0, 16),
    (4, 4, 64, 64, True, 24, 16),
    (6, 3, 64, 40, True, 0, 16),
    (4, 4, 37, 37, True, 0, 16),
    (2, 2, 32, 32, True, 0, 64),
]


@pytest.mark.parametrize("hq,hkv,s,kv_len,causal,window,d",
                         FLASH_STATIC_CASES)
def test_flash_static_matches_pallas(hq, hkv, s, kv_len, causal, window, d):
    rng = np.random.default_rng(9)
    q, k, v = (_rand(rng, hq, s, d), _rand(rng, hkv, s, d),
               _rand(rng, hkv, s, d))
    got = K.flash_attention_2d(*(torch.from_numpy(a) for a in (q, k, v)),
                               kv_len=kv_len, causal=causal, window=window,
                               kv_group=hq // hkv, block_kv=16)
    want = j_flash_2d(*(jnp.asarray(a) for a in (q, k, v)), kv_len=kv_len,
                      causal=causal, window=window, kv_group=hq // hkv,
                      block_q=16, block_kv=16)
    _close(got, want)


def test_model_layout_static_flash_matches_pallas():
    """``ops.flash_attention`` without ``q_offset``: the static branch."""
    rng = np.random.default_rng(10)
    b, s, hq, hkv, d = 2, 24, 4, 4, 16
    q, k, v = (_rand(rng, b, s, hq, d), _rand(rng, b, s, hkv, d),
               _rand(rng, b, s, hkv, d))
    got = K.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            block_kv=8)
    want = j_flash(*(jnp.asarray(a) for a in (q, k, v)), block_q=8,
                   block_kv=8)
    _close(got, want)


def test_flash_offset_head_dim_64_matches_pallas():
    """K2 at gpt2's head dim: MHA, a chunk at a nonzero offset."""
    rng = np.random.default_rng(11)
    h, sq, skv, d, q_off, kv_len = 4, 16, 64, 64, 32, 48
    q, k, v = (_rand(rng, h, sq, d), _rand(rng, h, skv, d),
               _rand(rng, h, skv, d))
    got = K.flash_attention_2d(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_offset=q_off, kv_len=kv_len, block_kv=16)
    want = j_flash_2d(*(jnp.asarray(a) for a in (q, k, v)), q_offset=q_off,
                      kv_len=kv_len, block_q=16, block_kv=16)
    _close(got, want)


def test_paged_decode_head_dim_64_matches_pallas():
    """K1 at gpt2's head dim and group size 1, with an idle slot."""
    rng = np.random.default_rng(12)
    b, h, d, ps, maxp = 4, 4, 64, 8, 5
    pages = 1 + b * maxp
    kp, vp = _rand(rng, pages, ps, h, d), _rand(rng, pages, ps, h, d)
    table = (rng.permutation(pages - 1)[:b * maxp] + 1).reshape(b, maxp)
    table = table.astype(np.int32)
    lengths = np.array([37, 9, 1, 0], np.int32)
    q = _rand(rng, b, 1, h, d)
    got = K.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, lengths)))
    want = j_paged(*(jnp.asarray(a) for a in (q, kp, vp, table, lengths)))
    _close(got, want)
    assert torch.count_nonzero(got[3]) == 0


# (heads q, heads kv, Sq, Skv, q_offset, kv_len, window): GQA, a chunk at a
# nonzero offset, a partly filled extent (kv_len < Skv), a sliding window.
FLASH_CASES = [
    (4, 2, 16, 64, 0, 16, 0),
    (4, 2, 16, 64, 32, 48, 0),
    (8, 2, 32, 128, 64, 96, 0),
    (4, 4, 16, 64, 32, 48, 24),
    (6, 3, 8, 40, 16, 24, 0),
]


@pytest.mark.parametrize("hq,hkv,sq,skv,q_off,kv_len,window", FLASH_CASES)
def test_flash_offset_matches_pallas(hq, hkv, sq, skv, q_off, kv_len, window):
    rng = np.random.default_rng(2)
    d = 16
    q, k, v = (_rand(rng, hq, sq, d), _rand(rng, hkv, skv, d),
               _rand(rng, hkv, skv, d))
    got = K.flash_attention_2d(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_offset=q_off, kv_len=kv_len, window=window,
                               kv_group=hq // hkv, block_kv=16)
    want = j_flash_2d(*(jnp.asarray(a) for a in (q, k, v)), q_offset=q_off,
                      kv_len=kv_len, window=window, kv_group=hq // hkv,
                      block_q=8, block_kv=16)
    _close(got, want)


def test_model_layout_flash_matches_pallas():
    """The GQA kv-head-major flatten of ``ops.flash_attention``."""
    rng = np.random.default_rng(3)
    b, sq, skv, hq, hkv, d = 1, 16, 48, 4, 2, 16
    q, k, v = (_rand(rng, b, sq, hq, d), _rand(rng, b, skv, hkv, d),
               _rand(rng, b, skv, hkv, d))
    got = K.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            q_offset=16, kv_len=32, block_kv=16)
    want = j_flash(*(jnp.asarray(a) for a in (q, k, v)), q_offset=16,
                   kv_len=32, block_q=16, block_kv=16)
    _close(got, want)


@pytest.mark.parametrize("hq,hkv,window", [(4, 2, 0), (8, 2, 0), (4, 4, 0),
                                           (4, 2, 9)])
def test_paged_decode_matches_pallas(hq, hkv, window):
    rng = np.random.default_rng(4)
    b, d, ps, maxp = 4, 16, 8, 6
    pages = 1 + b * maxp
    kp, vp = _rand(rng, pages, ps, hkv, d), _rand(rng, pages, ps, hkv, d)
    table = (rng.permutation(pages - 1)[:b * maxp] + 1).reshape(b, maxp)
    table = table.astype(np.int32)
    table[2, 3:] = 0                       # unallocated: the NULL page
    lengths = np.array([41, 7, 20, 0], np.int32)   # slot 3 inactive
    q = _rand(rng, b, 1, hq, d)
    got = K.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, lengths)),
        window=window)
    want = j_paged(*(jnp.asarray(a) for a in (q, kp, vp, table, lengths)),
                   window=window)
    _close(got, want)
    assert torch.count_nonzero(got[3]) == 0     # length 0 gives zeros


def test_cpu_tensors_take_the_plain_path_without_a_launch():
    K.reset_launches()
    x = torch.randn(4, 32)
    K.rmsnorm_matmul(x, torch.zeros(32), torch.randn(32, 8))
    K.streamed_ffn(x, torch.randn(32, 16), torch.randn(32, 16),
                   torch.randn(16, 32))
    K.block_matmul(x, torch.randn(32, 8))
    K.streamed_mlp(x, torch.randn(32, 16), torch.randn(16, 32))
    q = torch.randn(2, 8, 16)
    K.flash_attention_2d(q, q, q)
    K.flash_attention_2d(q, q, q, q_offset=0)
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}


def _off_path_calls():
    x, w_up, w_down = torch.randn(4, 32), torch.randn(32, 16), \
        torch.randn(16, 32)
    q, kv = torch.randn(4, 8, 128), torch.randn(2, 16, 128)
    qd, pool = torch.randn(2, 1, 4, 128), torch.randn(5, 4, 2, 128)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lengths = torch.tensor([5, 0], dtype=torch.int32)
    # The int8 twins' operands: codes and float32 scales.
    w8_ffn = (torch.zeros(32, 16, dtype=torch.int8),
              torch.zeros(32, 16, dtype=torch.int8),
              torch.zeros(16, 32, dtype=torch.int8))
    w8_ffn_scales = dict(wg_scale=torch.ones(16), wu_scale=torch.ones(16),
                         wd_scale=torch.ones(32))
    code_pool = pool.to(torch.int8)
    pool_scale = torch.ones(5, 2)
    kv_scale = torch.ones(2, 16)
    return {
        # GELU runs on the card with the norm folded in and without it,
        # over int8 weights too (gemma3, zamba2); the int8 GLU's SiLU
        # still needs the folded norm.
        "ffn_gelu": ("streamed_ffn", lambda: K.streamed_ffn_w8(
            x, *w8_ffn, activation="silu", **w8_ffn_scales)),
        "ffn_no_norm": ("streamed_ffn", lambda: K.streamed_ffn(
            x, w_up, w_up, w_down)),
        # A sliding window runs on the card with causal masking only.
        "flash_window": ("flash_attention", lambda: K.flash_attention_2d(
            q, kv, kv, q_offset=8, kv_group=2, window=4, causal=False)),
        "flash_not_causal": ("flash_attention", lambda: K.flash_attention_2d(
            q, kv, kv, q_offset=8, kv_group=2, causal=False)),
        "flash_head_dim_96": ("flash_attention", lambda: K.flash_attention_2d(
            *(t[..., :96].contiguous() for t in (q, kv, kv)), q_offset=8,
            kv_group=2)),
        # A window at head dim 320 holds 32 rows x query heads at most.
        "paged_window": ("paged_attention", lambda: K.paged_verify_attention(
            torch.randn(2, 20, 4, 320), torch.randn(5, 4, 2, 320),
            torch.randn(5, 4, 2, 320), table, lengths, window=3)),
        "paged_head_dim_96": ("paged_attention",
                              lambda: K.paged_decode_attention(
                                  *(t[..., :96].contiguous()
                                    for t in (qd, pool, pool)),
                                  table, lengths)),
        "mlp_silu": ("streamed_ffn", lambda: K.streamed_mlp(
            x, w_up, w_down, activation="silu")),
        "mlp_folded_norm": ("streamed_ffn", lambda: K.streamed_mlp(
            x, w_up, w_down, norm_scale=torch.zeros(32))),
        "static_window": ("flash_attention", lambda: K.flash_attention_2d(
            q, kv, kv, kv_group=2, window=4, causal=False)),
        # The static branch runs non-causal attention (hubert) only
        # without a window.
        "static_not_causal": ("flash_attention",
                              lambda: K.flash_attention_2d(
                                  *(t[..., :80].contiguous()
                                    for t in (q, kv, kv)), kv_group=2,
                                  window=4, causal=False)),
        "static_head_dim_96": ("flash_attention",
                               lambda: K.flash_attention_2d(
                                   *(t[..., :96].contiguous()
                                     for t in (q, kv, kv)), kv_group=2)),
        # ... and the int8 MLP (gpt2's) runs GELU only.
        "ffn_w8_gelu": ("streamed_ffn", lambda: K.streamed_mlp_w8(
            x, w8_ffn[1], w8_ffn[2], activation="silu",
            wu_scale=w8_ffn_scales["wu_scale"],
            wd_scale=w8_ffn_scales["wd_scale"])),
        "mlp_w8_folded_norm": ("streamed_ffn", lambda: K.streamed_mlp_w8(
            x, w8_ffn[1], w8_ffn[2], norm_scale=torch.zeros(32),
            wu_scale=w8_ffn_scales["wu_scale"],
            wd_scale=w8_ffn_scales["wd_scale"])),
        # A window over code pools runs on the card (gemma3) but, at head
        # dim 320, for 32 rows x query heads at most, as over
        # full-precision pools.
        "paged_q_window": ("paged_attention",
                           lambda: K.paged_verify_attention_q(
                               torch.randn(2, 20, 4, 320),
                               torch.zeros(5, 4, 2, 320, dtype=torch.int8),
                               torch.zeros(5, 4, 2, 320, dtype=torch.int8),
                               table, lengths, k_scale=pool_scale,
                               v_scale=pool_scale, window=3)),
        # A window over codes runs causal only.
        "flash_q_window": ("flash_attention", lambda: K.flash_attention_2d_q(
            q, kv.to(torch.int8), kv.to(torch.int8), k_scale=kv_scale,
            v_scale=kv_scale, q_offset=8, kv_group=2, window=4,
            causal=False)),
    }


@pytest.mark.parametrize("case", sorted(_off_path_calls()))
def test_cuda_path_refuses_cases_the_kernel_does_not_build(monkeypatch, case):
    """The CUDA kernels build only the main path's cases; the wrappers
    refuse the rest before any build or launch (the CPU tensors here stand
    in for CUDA ones by forcing the wrapper's kernel route)."""
    module, call = _off_path_calls()[case]
    wrapper = importlib.import_module(f"repro_torch.kernels.{module}")
    monkeypatch.setattr(wrapper, "kernel_path", lambda t: "cuda")
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(
        f"{case}: reached the build"))
    with pytest.raises(ValueError, match="the CUDA kernel runs"):
        call()


def test_other_devices_are_refused():
    x = torch.empty(4, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.rmsnorm_matmul(x, torch.empty(32, device="meta"),
                         torch.empty(32, 8, device="meta"))


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        K.rmsnorm_matmul(torch.randn(4, 32), torch.zeros(16),
                         torch.randn(32, 8))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_pick_block_matches_reference_policy():
    from repro.kernels.common import pick_block as j_pick_block
    for extent in (1, 16, 96, 128, 256, 384, 1000, 2048):
        for target in (16, 128, 512):
            assert pick_block(extent, target) == j_pick_block(extent, target)
