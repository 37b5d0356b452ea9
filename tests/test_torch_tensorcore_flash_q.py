"""K9c (``flash_attention_2d_q``, the offset flash attention over int8 /
fp8 K/V codes) on the tensor cores, on the CPU.

Its CUDA code runs only on the card (``chip_smoke.py``'s ``tensorcore``
phase holds it there against the plain version and SDPA on dequantized
K/V, and a chunk's rows bit for bit against one chunk from offset 0:
``tensorcore_offset_q``; ``chip_phases.py flash_q_hashes`` hashes the
float32 kernel's outputs against another tree's).  Here: the route each
dtype takes to its C entry point with aligned operands (a fake library
stands in for the build), the refusals, the profile's attribution of the
new kernel, and a float32 model of the kernel's algorithm (64-key tiles
from position 0, each score scaled by its key's k scale after the MMA,
the row max taken after that, p times the key's v scale split into hi +
lo bf16 planes against the exact codes) against the interpret-mode
Pallas kernel at the 64-key tile edges, GQA groups 1, 3 and 4, int8 and
fp8, at relative 1e-5.
"""

import importlib
import types

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention_2d as j_flash_2d
from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.serving import kv_cache as tkv

from test_torch_tensorcore import _FakeLib, _global_functions, _own_kernels


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
BF16, F32 = torch.bfloat16, torch.float32
FP8 = torch.float8_e4m3fn
CODES = {"int8": torch.int8, "fp8": FP8}
REL = 1e-5
BKV = 64    # the tensor-core kernel's key tile


@pytest.fixture
def card_route(monkeypatch):
    """Force the CUDA route for CPU tensors, with every library a
    ``_FakeLib``; returns the list of recorded launches."""
    calls = []
    monkeypatch.setattr(fa_mod, "kernel_path", lambda t: "cuda")
    fa_mod._entry.cache_clear()
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(name, calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    yield calls
    fa_mod._entry.cache_clear()


def _unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` at an address 1 element past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 16, dtype=t.dtype)
    base = (16 - flat.data_ptr() % 16) % 16 // t.element_size()
    out = flat[base + 1:base + 1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def _call(dtype, code, d=64, hq=6, hkv=2, sq=37, skv=160, q_offset=65,
          unaligned=False, **kw):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(hq, sq, d, generator=gen).to(dtype)
    c = torch.randn(hkv, skv, d, generator=gen).clamp(-1, 1).to(code)
    if unaligned:
        q, c = _unaligned(q), _unaligned(c)
    sc = torch.ones(hkv, skv)
    kw = dict(q_offset=q_offset, kv_len=q_offset + sq,
              kv_group=hq // hkv) | kw
    K.flash_attention_2d_q(q, c, c, k_scale=sc, v_scale=sc, **kw)
    return q, c


@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("unaligned", [False, True])
def test_bf16_k9c_reaches_the_tensor_core_entry(card_route, code, unaligned):
    """bf16: ``flash_mma``'s ``repro_flash_offset_q_mma_bf16_{i8,fp8}``
    with 16-byte aligned q and codes (an unaligned operand is copied), the
    scales, the shapes and the softmax scale."""
    before = K.flash_attention_2d_q.launches
    _call(BF16, CODES[code], unaligned=unaligned)
    (lib, symbol, args), = card_route
    suffix = {"int8": "i8", "fp8": "fp8"}[code]
    assert (lib, symbol) == ("flash_mma",
                             f"repro_flash_offset_q_mma_bf16_{suffix}")
    assert all(a % 16 == 0 for a in args[:3] + args[5:6])
    assert args[6:14] == (6, 37, 160, 64, 3, 65, 102, 0)   # no window
    assert args[14] == pytest.approx(1 / 8)
    assert K.flash_attention_2d_q.launches == before + 1


@pytest.mark.parametrize("code", sorted(CODES))
def test_f32_k9c_keeps_the_cuda_core_entry(card_route, code):
    suffix = {"int8": "i8", "fp8": "fp8"}[code]
    _call(F32, CODES[code])
    (lib, symbol, args), = card_route
    assert (lib, symbol) == ("flash_attention",
                             f"repro_flash_offset_q_f32_{suffix}")
    assert args[6:14] == (6, 37, 160, 64, 3, 65, 102, 0)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("bad", ["window", "non-causal", "head dim 80",
                                 "head dim 32", "mixed codes",
                                 "bf16 scales"])
def test_k9c_refusals_are_unchanged(card_route, dtype, bad):
    """The card refuses what no main path runs, before any launch."""
    kw, d = {}, 64
    if bad == "window":      # a window runs causal only
        kw = dict(window=16, causal=False)
    elif bad == "non-causal":
        kw = dict(causal=False)
    elif bad.startswith("head dim"):
        d = int(bad.split()[-1])
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(6, 8, d, generator=gen).to(dtype)
    k = torch.randn(2, 72, d, generator=gen).clamp(-1, 1).to(torch.int8)
    v = k.float().to(FP8) if bad == "mixed codes" else k.clone()
    sc = torch.ones(2, 72, dtype=BF16 if bad == "bf16 scales" else F32)
    with pytest.raises((ValueError, TypeError)):
        K.flash_attention_2d_q(q, k, v, k_scale=sc, v_scale=sc,
                               q_offset=64, kv_group=3, **kw)
    assert card_route == []


def test_profile_attributes_k9c_to_its_own_stage():
    names = _global_functions()
    assert {"flash_mma_kernel", "flash_mma_q_kernel",
            "flash_offset_kernel"} <= names
    stage = dict(_own_kernels())
    hits = [k for k in stage if k in "flash_mma_q_kernel"]
    assert len(hits) == 1 and "K9c" in stage[hits[0]]
    assert [k for k in stage if k in "flash_mma_kernel"] == [
        "flash_mma_kernel"]


# --------------------------------------------------------------------- #
# A float32 model of the tensor-core algorithm
# --------------------------------------------------------------------- #

def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).float()


def k9c_model(q, kc, vc, ks, vs, *, q_offset, kv_len, kv_group, scale):
    """q [Hq, Sq, D] (bf16 values), kc / vc [Hkv, Skv, D] codes as float32,
    ks / vs [Hkv, Skv] -> [Hq, Sq, D] float32, as the kernel computes it:
    64-key tiles from position 0 up to the chunk's last position; per tile
    s = (q . code) * (ks * scale), masked scores out of the row max, which
    is taken after the multiply; p = exp(s - m) summed unscaled into the
    normaliser; p' = p * vs split into hi + lo bf16 planes, each times the
    exact codes; the normaliser clamped at 1e-30."""
    hq, sq, d = q.shape
    skv = kc.shape[1]
    lim = min(kv_len, skv)
    pos = q_offset + torch.arange(sq)[:, None]
    n_tiles = -(-min(lim, q_offset + sq) // BKV)
    out = torch.empty(hq, sq, d)
    for h in range(hq):
        hk = h // kv_group
        m = torch.full((sq,), -1e30)
        l = torch.zeros(sq)
        o = torch.zeros(sq, d)
        for t in range(n_tiles):
            kp = t * BKV + torch.arange(BKV)
            live = kp < skv
            kt = torch.zeros(BKV, d)
            vt = torch.zeros(BKV, d)
            kt[live], vt[live] = kc[hk, kp[live]], vc[hk, kp[live]]
            kst = torch.zeros(BKV)
            vst = torch.zeros(BKV)
            kst[live] = ks[hk, kp[live]] * scale
            vst[live] = vs[hk, kp[live]]
            s = (q[h] @ kt.T) * kst
            mask = (kp[None, :] <= pos) & (kp[None, :] < lim)
            s = torch.where(mask, s, -torch.inf)
            mx = torch.maximum(m, s.max(dim=1).values)
            corr = torch.exp(m - mx)
            p = torch.where(mask, torch.exp(s - mx[:, None]), 0.0)
            l = l * corr + p.sum(dim=1)
            pv = p * vst
            hi = _bf16(pv)
            lo = _bf16(pv - hi)
            o = o * corr[:, None] + hi @ vt + lo @ vt
            m = mx
        out[h] = o / torch.clamp(l, min=1e-30)[:, None]
    return out


def _to_jax(t: torch.Tensor):
    if t.dtype == FP8:
        return jnp.asarray(t.view(torch.uint8).numpy()
                           .view(ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("q_offset,sq,group", [(0, 64, 1), (63, 2, 3),
                                               (65, 37, 4), (128, 64, 3)])
def test_k9c_model_matches_pallas_at_tile_edges(q_offset, sq, group, code):
    """The model against the interpret-mode Pallas
    ``_flash_kernel_offset_q`` on numpy-seeded inputs (q rounded to bf16,
    as the kernel reads it), per-position scales, 5
    gathered positions past kv_len."""
    rng = np.random.default_rng(q_offset * 100 + sq * 10 + group)
    hkv, d = 2, 64
    n = q_offset + sq
    skv = n + 5
    dt = CODES[code]
    x = torch.from_numpy(rng.standard_normal((2, hkv, skv, d))
                         .astype(np.float32))
    scale_pos = x.abs().amax(dim=-1) / tkv.kv_quant_qmax(dt)  # [2,Hkv,Skv]
    k, v = (tkv.quantize_kv(x[i], scale_pos[i][..., None], dt)
            for i in range(2))
    q = _bf16(torch.from_numpy(rng.standard_normal((hkv * group, sq, d))
                               .astype(np.float32)))
    scale = 1.0 / np.sqrt(d)
    got = k9c_model(q, k.float(), v.float(), scale_pos[0], scale_pos[1],
                    q_offset=q_offset, kv_len=n, kv_group=group,
                    scale=scale)
    want = np.asarray(j_flash_2d(
        _to_jax(q), _to_jax(k), _to_jax(v), q_offset=q_offset, kv_len=n,
        kv_group=group, k_scale=_to_jax(scale_pos[0]),
        v_scale=_to_jax(scale_pos[1]), scale=scale, interpret=True),
        np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())

