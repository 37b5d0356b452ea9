"""Quantized serving in the port on the CPU, against the JAX package
(DESIGN.md §14): int8 / fp8-e4m3 KV pages with per-(page, KV head) scales
and weight-only int8 matmul stages.

* The quantize-on-write primitives, whole-page placement, dequantizing
  gathers and per-channel weight quantization give JAX's codes and scales
  bit for bit (fp8 codes compared as bytes), zero pages and zero columns
  included, and a window that grows a page's scale re-encodes its rows as
  JAX does.
* The plain versions of the quantized kernel twins (K9a decode, K9b
  verify, K9c chunk flash; K10a rmsnorm_matmul, K10b streamed_ffn, K10c
  streamed_mlp) equal the interpret-mode Pallas bodies at relative 1e-5,
  and every K9b row equals K9a at its length bit for bit.
* ``prefill_chunk`` / ``decode_step`` / ``verify_step`` logits under
  kv_int8, kv_fp8 and w8_kv8 at relative 1e-5; the w8 plan flags; the
  page accounting's value/scale lockstep audit; the engine's
  copy-on-write of scale rows.  The engine and the accuracy gate are held
  to the reference in ``test_torch_quantized_serving.py``.

Everything runs in float32 on weights the JAX ``init_params`` draws (gpt2
jittered), bridged with ``params_from_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from test_torch_stream_plan import j_plan_for  # the reference on H100
from repro.kernels import flash_attention_2d as j_flash_2d
from repro.kernels import paged_decode_attention as j_paged_decode
from repro.kernels import paged_verify_attention as j_paged_verify
from repro.kernels import rmsnorm_matmul as j_rmsnorm_matmul
from repro.kernels import streamed_ffn as j_streamed_ffn
from repro.kernels import streamed_mlp as j_streamed_mlp
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import prefill_chunk as j_prefill_chunk
from repro.models import verify_step as j_verify_step
from repro.serving import PagedKVCache as JPagedKVCache
from repro.serving import kv_cache as jkv
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.core.stream_plan import STAGES, plan_for
from repro_torch.models import (decode_step, params_from_numpy,
                                prefill_chunk, verify_step)
from repro_torch.models import layers as L
from repro_torch.models.params import (dequantize_weights, quantize_weights,
                                       weight_bytes)
from repro_torch.serving import PagedKVCache, ServingEngine
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
ARCHS = ("llama3-8b", "gpt2")
KINDS = ("int8", "fp8")
FP8 = torch.float8_e4m3fn


# ------------------------------------------------------------- helpers

def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _np(t: torch.Tensor) -> np.ndarray:
    """Bytes for fp8 codes (compared bit for bit), else the values."""
    return t.view(torch.uint8).numpy() if t.dtype == FP8 else t.numpy()


def _jnp_bytes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(_np(got), _jnp_bytes(want))


def _to_jax(t: torch.Tensor):
    if t.dtype == FP8:
        return jnp.asarray(t.view(torch.uint8).numpy()
                           .view(ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.numpy())


def _dtypes(kind):
    return tkv.kv_quant_dtype(kind), jkv.kv_quant_dtype(kind)


def _pool(kind, pages=6, ps=4, h=2, hd=8):
    tdt, jdt = _dtypes(kind)
    tp = torch.zeros((pages, ps, h, hd), dtype=torch.uint8).view(tdt) \
        if tdt == FP8 else torch.zeros((pages, ps, h, hd), dtype=tdt)
    return (tp, torch.zeros((pages, h)),
            jnp.zeros((pages, ps, h, hd), jdt), jnp.zeros((pages, h)))


def _configs(arch: str, fused: bool, quant: str = "none"):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="float32", use_fused_kernels=fused,
                                quant=quant)
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                use_fused_kernels=fused, quant=quant)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def weights():
    """{arch: (jax params, port params)}; gpt2 jittered, or its
    zero-initialised LayerNorm scales make every logit zero."""
    out = {}
    for arch in ARCHS:
        j_cfg, t_cfg = _configs(arch, False)
        jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
        if arch == "gpt2":
            jp = j_jitter_params(jp)
        out[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           t_cfg, device="cpu"))
    return out


# ------------------------------------------------- codes bit for bit

@pytest.mark.parametrize("kind", KINDS)
def test_quantize_and_requant_codes_match_reference(kind):
    tdt, jdt = _dtypes(kind)
    assert tkv.kv_quant_qmax(tdt) == jkv.kv_quant_qmax(jdt)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 4, 16)) * 3).astype(np.float32)
    x[1] = 0.0                                       # a zero page
    scale = np.abs(x).max(-1, keepdims=True) / jkv.kv_quant_qmax(jdt)
    scale[2, 1] = 0.0                                # zero scale: codes 0
    got = tkv.quantize_kv(torch.from_numpy(x), torch.from_numpy(scale), tdt)
    want = jkv.quantize_kv(jnp.asarray(x), jnp.asarray(scale), jdt)
    _same(got, want)
    assert not _np(got)[1].any() and not _np(got)[2, 1].any()
    grown = scale * np.float32(1.7)
    _same(tkv._requant_codes(got, torch.from_numpy(scale),
                             torch.from_numpy(grown)),
          jkv._requant_codes(want, jnp.asarray(scale), jnp.asarray(grown)))
    # At an unchanged scale the ratio is exactly 1: an identity.
    _same(tkv._requant_codes(got, torch.from_numpy(scale),
                             torch.from_numpy(scale)), want)


@pytest.mark.parametrize("kind", KINDS)
def test_paged_appends_match_reference(kind):
    """Single-token appends into two pages (the second token of a page
    grows its scale), then a 3-row window straddling the page boundary
    with a row large enough to grow the scale again; two slots, one
    parked at the table extent (its writes go to the NULL page, which is
    left out: duplicate NULL writes are unordered)."""
    tp, ts, jp, js = _pool(kind)
    table = np.array([[1, 2, 5], [3, 4, 0]], np.int32)
    rng = np.random.default_rng(1)
    for i in range(6):
        tok = rng.standard_normal((2, 1, 2, 8)).astype(np.float32) * (1 + i)
        pos = np.array([i, 12], np.int32)
        tkv.paged_append_q(tp, ts, torch.from_numpy(table),
                           torch.from_numpy(pos), torch.from_numpy(tok),
                           layout="bshd")
        jp, js = jkv.paged_append_q(jp, js, jnp.asarray(table),
                                    jnp.asarray(pos), jnp.asarray(tok),
                                    layout="bshd")
    win = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    win[0, 1] *= 20.0                                # grows page 2's scale
    pos = np.array([6, 1], np.int32)
    tkv.paged_append_window_q(tp, ts, torch.from_numpy(table),
                              torch.from_numpy(pos), torch.from_numpy(win),
                              layout="bshd")
    jp, js = jkv.paged_append_window_q(jp, js, jnp.asarray(table),
                                       jnp.asarray(pos), jnp.asarray(win),
                                       layout="bshd")
    _same(tp[1:], np.asarray(jp)[1:])
    _same(ts[1:], np.asarray(js)[1:])
    assert float(ts[2].max()) > 0
    dense = tkv.gather_pages_dequant(tp, ts, torch.from_numpy(table),
                                     layout="bshd")
    _same(dense, jkv.gather_pages_dequant(jp, js, jnp.asarray(table),
                                          layout="bshd"))


@pytest.mark.parametrize("kind", KINDS)
def test_whole_page_placement_matches_reference(kind):
    """``place_chunk_pages_q`` (a zero page included) and the quantized
    ``place_prefill`` of a 13-token prompt into 4 pages (the last one
    zero-padded): codes set from each page's own amax."""
    tp, ts, jp, js = _pool(kind)
    rng = np.random.default_rng(2)
    seq = rng.standard_normal((1, 12, 2, 8)).astype(np.float32)
    seq[:, 4:8] = 0.0
    pages = np.array([1, 3, 5], np.int32)
    tkv.place_chunk_pages_q(tp, ts, torch.from_numpy(seq),
                            torch.from_numpy(pages), layout="bshd")
    jp, js = jkv.place_chunk_pages_q(jp, js, jnp.asarray(seq),
                                     jnp.asarray(pages), layout="bshd")
    _same(tp, jp)
    _same(ts, js)
    assert float(ts[3].abs().max()) == 0.0

    tdt, jdt = _dtypes(kind)
    layers = 2
    t_cache, j_leaves = {}, {}
    for name in ("k", "v"):
        t_cache[name] = torch.zeros((layers, 6, 4, 2, 8),
                                    dtype=torch.uint8).view(tdt) \
            if tdt == FP8 else torch.zeros((layers, 6, 4, 2, 8), dtype=tdt)
        t_cache[name + "_scale"] = torch.zeros((layers, 6, 2))
        j_leaves[name] = jnp.zeros((layers, 6, 4, 2, 8), jdt)
        j_leaves[name + "_scale"] = jnp.zeros((layers, 6, 2))
    j_cache = {"blocks": (j_leaves,), "rest": ()}
    fresh = {name: rng.standard_normal((layers, 1, 13, 2, 8))
             .astype(np.float32) for name in ("k", "v")}
    slot_pages = np.array([2, 4, 1, 5], np.int32)
    tkv.place_prefill(t_cache, {k: torch.from_numpy(v)
                                for k, v in fresh.items()},
                      torch.from_numpy(slot_pages), layout="bshd")
    j_out = jkv.place_prefill(
        j_cache, {"blocks": ({k: jnp.asarray(v) for k, v in fresh.items()},),
                  "rest": ()}, jnp.int32(0), jnp.asarray(slot_pages),
        layout="bshd")
    for name in t_cache:
        _same(t_cache[name], j_out["blocks"][0][name])


def test_channelwise_weight_quantization_matches_reference():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((16, 6)).astype(np.float32)
    w[:, 2] = 0.0                                    # a zero column
    w[3, 4] = 2.5 * 127                              # a half-way code
    codes, scales = L.quantize_channelwise(torch.from_numpy(w))
    j_codes, j_scales = JL.quantize_channelwise(jnp.asarray(w))
    _same(codes, j_codes)
    _same(scales, j_scales)
    assert float(scales[2]) == 0.0 and not codes[:, 2].any()
    _same(L.dequantize_channelwise(codes, scales, torch.float32),
          JL.dequantize_channelwise(j_codes, j_scales, jnp.float32))


def test_quantize_weights_caches_the_reference_codes(weights):
    """The engine's once-per-tree codes are ``quantize_channelwise`` of
    each w8 stage's weight; every other leaf is shared, and the eager w8
    reference dequantizes them back."""
    for arch in ARCHS:
        _, tp = weights[arch]
        _, t_cfg = _configs(arch, True, "w8_kv8")
        q = quantize_weights(t_cfg, tp)
        for i, lp in enumerate(q["layers"]):
            src = tp["layers"][i]
            for sub, names in (("attn", ("wq", "wk", "wv", "wo")),
                               ("mlp", ("wg", "wu", "wd"))):
                for n in names:
                    if n not in src[sub]:
                        continue
                    w8 = n in ("wg", "wu", "wd") or (
                        arch == "llama3-8b" and n != "wo")
                    if not w8:
                        assert lp[sub][n] is src[sub][n]
                        continue
                    codes, scales = lp[sub][n]
                    jc, js = JL.quantize_channelwise(
                        jnp.asarray(src[sub][n].numpy()))
                    _same(codes, jc)
                    _same(scales, js)
        assert q["lm_head"] is tp["lm_head"]
        assert weight_bytes(q) < weight_bytes(tp)
        back = dequantize_weights(t_cfg, q)["layers"][0]["mlp"]["wu"]
        w = jnp.asarray(tp["layers"][0]["mlp"]["wu"].numpy())
        _same(back, JL.dequantize_channelwise(*JL.quantize_channelwise(w),
                                              jnp.float32))
        # The eager plan keeps full-precision weights, as the reference.
        assert quantize_weights(dataclasses.replace(
            t_cfg, use_fused_kernels=False), tp) is tp


# ---------------------------------------------- kernels vs Pallas

def _code_pools(rng, kind, hkv, d, n_pages=13, ps=8):
    """Code pools with per-(page, head) scales from random values."""
    tdt, _ = _dtypes(kind)
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((n_pages, ps, hkv, d))
                             .astype(np.float32))
        s = x.abs().amax(dim=(1, 3)) / tkv.kv_quant_qmax(tdt)
        out += [tkv.quantize_kv(x, s[:, None, :, None], tdt), s]
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_paged_twins_match_pallas(kind, hq, hkv):
    """K9a and K9b plain versions against the interpret-mode quantized
    bodies; every K9b row equals K9a at its length, bit for bit."""
    rng = np.random.default_rng(4)
    b, w, d = 3, 5, 16
    kp, ks, vp, vs = _code_pools(rng, kind, hkv, d)
    table = torch.from_numpy(np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 0, 0, 0],
                                       [10, 11, 0, 0, 0, 0]], np.int32))
    q = torch.from_numpy(rng.standard_normal((b, w, hq, d))
                         .astype(np.float32))
    q_off = torch.tensor([40, 17, 0], dtype=torch.int32)
    lengths = torch.tensor([45, 20, 0], dtype=torch.int32)
    jargs = dict(k_scale=_to_jax(ks), v_scale=_to_jax(vs), interpret=True)
    K.reset_launches()
    dec = K.paged_decode_attention_q(q[:, :1].contiguous(), kp, vp, table,
                                     lengths, k_scale=ks, v_scale=vs)
    _rel_close(dec.numpy(), j_paged_decode(
        _to_jax(q[:, :1].contiguous()), _to_jax(kp), _to_jax(vp),
        _to_jax(table), _to_jax(lengths), **jargs))
    ver = K.paged_verify_attention_q(q, kp, vp, table, q_off, k_scale=ks,
                                     v_scale=vs)
    _rel_close(ver.numpy(), j_paged_verify(
        _to_jax(q), _to_jax(kp), _to_jax(vp), _to_jax(table),
        _to_jax(q_off), **jargs))
    for i in range(w):
        row = K.paged_decode_attention_q(
            q[:, i:i + 1].contiguous(), kp, vp, table, q_off + i + 1,
            k_scale=ks, v_scale=vs)
        assert torch.equal(ver[:, i:i + 1], row), i
    assert all(n == 0 for n in K.launch_counts().values())   # CPU: plain


@pytest.mark.parametrize("kind", KINDS)
def test_flash_twin_matches_pallas(kind):
    """K9c: a 32-row chunk at offset 64 over 128 gathered code positions
    with per-position scales, GQA."""
    rng = np.random.default_rng(5)
    hkv, g, d, skv = 2, 2, 16, 128
    tdt, _ = _dtypes(kind)
    x = torch.from_numpy(rng.standard_normal((2, hkv, skv, d))
                         .astype(np.float32))
    pos_scale = x.abs().amax(dim=-1) / tkv.kv_quant_qmax(tdt)  # [2,Hkv,Skv]
    k, v = (tkv.quantize_kv(x[i], pos_scale[i][..., None], tdt)
            for i in range(2))
    q = torch.from_numpy(rng.standard_normal((hkv * g, 32, d))
                         .astype(np.float32))
    got = K.flash_attention_2d_q(q, k, v, k_scale=pos_scale[0],
                                 v_scale=pos_scale[1], q_offset=64,
                                 kv_len=96, kv_group=g, block_kv=32)
    want = j_flash_2d(_to_jax(q), _to_jax(k), _to_jax(v), q_offset=64,
                      kv_len=96, kv_group=g, block_q=32, block_kv=32,
                      k_scale=_to_jax(pos_scale[0]),
                      v_scale=_to_jax(pos_scale[1]), interpret=True)
    _rel_close(got.numpy(), want)


@pytest.mark.parametrize("t", [4, 20])
def test_w8_matmul_twins_match_pallas(t):
    """K10a, K10b and K10c plain versions against the interpret-mode w8
    bodies, with a zero output column."""
    rng = np.random.default_rng(6)
    d, n, f = 32, 24, 64

    def q8(*shape):
        w = rng.standard_normal(shape).astype(np.float32)
        w[:, 1] = 0.0
        return L.quantize_channelwise(torch.from_numpy(w))

    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    s = torch.from_numpy(0.1 * rng.standard_normal(d).astype(np.float32))
    c, ws = q8(d, n)
    _rel_close(K.rmsnorm_matmul_w8(x, s, c, w_scale=ws).numpy(),
               j_rmsnorm_matmul(_to_jax(x), _to_jax(s), _to_jax(c),
                                w_scale=_to_jax(ws), interpret=True))
    (cg, sg), (cu, su), (cd, sd) = q8(d, f), q8(d, f), q8(f, d)
    _rel_close(K.streamed_ffn_w8(x, cg, cu, cd, wg_scale=sg, wu_scale=su,
                                 wd_scale=sd, norm_scale=s).numpy(),
               j_streamed_ffn(_to_jax(x), _to_jax(cg), _to_jax(cu),
                              _to_jax(cd), norm_scale=_to_jax(s),
                              wg_scale=_to_jax(sg), wu_scale=_to_jax(su),
                              wd_scale=_to_jax(sd), block_f=32,
                              interpret=True))
    _rel_close(K.streamed_mlp_w8(x, cu, cd, wu_scale=su,
                                 wd_scale=sd).numpy(),
               j_streamed_mlp(_to_jax(x), _to_jax(cu), _to_jax(cd),
                              wu_scale=_to_jax(su), wd_scale=_to_jax(sd),
                              block_f=32, interpret=True))


def test_row_norm_matches_eager_layer_norm():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    s, b = (torch.from_numpy(rng.standard_normal(64).astype(np.float32))
            for _ in range(2))
    _rel_close(K.layer_norm_rows(x, s, b).numpy(),
               np.asarray(JL.layer_norm(_to_jax(x), _to_jax(s), _to_jax(b))))


# ---------------------------------------------- the model vs JAX

# The eager plan's quantized branch is the same for both code types, and
# it has no w8 stage (as the reference's): it runs under kv_int8 only.
@pytest.mark.parametrize("mode,fused", [
    ("kv_int8", True), ("kv_int8", False), ("kv_fp8", True),
    ("w8_kv8", True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_decode_verify_match_reference(weights, arch, mode, fused):
    """A 40-token prompt in one chunk into slot 0, two decode steps with
    slot 1 idle, then a 5-row verify window: logits at relative 1e-5 and
    the slot's page scales."""
    jp, tp = weights[arch]
    j_cfg, t_cfg = _configs(arch, fused, mode)
    slots, max_len, ps, chunk = 2, 128, 16, 64
    jc = JPagedKVCache(j_cfg, slots=slots, max_len=max_len, page_size=ps)
    tc = PagedKVCache(t_cfg, slots=slots, max_len=max_len, page_size=ps,
                      device="cpu")
    jcache, tcache = jc.init_cache(), tc.init_cache()
    rng = np.random.default_rng(8)
    plen = 40
    prompt = rng.integers(0, t_cfg.vocab_size, plen).astype(np.int32)
    for kc in (jc, tc):
        kc.ensure(0, chunk)
    row = tc.table_row(0)
    toks, cpages, last = stage_chunk(prompt, 0, chunk, row, ps)
    jt, jl, jcache = j_prefill_chunk(jp, j_cfg, toks[None], jcache, row,
                                     cpages, 0, last)
    tt, tl, tcache = prefill_chunk(
        tp, t_cfg, torch.from_numpy(toks)[None], tcache,
        torch.from_numpy(row), torch.from_numpy(cpages), 0, last)
    _rel_close(tl.numpy(), jl)
    tok = np.array([[int(np.asarray(jt)[0, 0])], [0]], np.int32)
    pos = np.array([plen, tc.extent], np.int32)
    lengths = np.array([plen, 0], np.int32)
    for _ in range(2):
        for kc in (jc, tc):
            kc.ensure(0, int(pos[0]) + 1)
        jt, jl, jcache = j_decode_step(jp, j_cfg, tok, jcache, pos, lengths,
                                       page_table=jc.page_table)
        tt, tl, tcache = decode_step(
            tp, t_cfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos),
            torch.from_numpy(lengths), page_table=tc.page_table)
        _rel_close(tl.numpy()[0], np.asarray(jl)[0])
        tok = np.asarray(jt).copy()
        pos, lengths = pos + 1, lengths + 1
    window = np.zeros((slots, 5), np.int32)
    window[0, 0] = tok[0, 0]
    window[0, 1:] = rng.integers(0, t_cfg.vocab_size, 4)
    for kc in (jc, tc):
        kc.ensure(0, int(pos[0]) + 5)
    jg, jl, jcache = j_verify_step(jp, j_cfg, window, jcache, pos, lengths,
                                   page_table=jc.page_table)
    tg, tl, tcache = verify_step(
        tp, t_cfg, torch.from_numpy(window), tcache, torch.from_numpy(pos),
        torch.from_numpy(lengths), page_table=tc.page_table)
    _rel_close(tl.numpy()[0], np.asarray(jl)[0])
    np.testing.assert_array_equal(tg.numpy()[0], np.asarray(jg)[0])
    pages = tc.slot_pages(0)
    for name in ("k_scale", "v_scale"):
        _rel_close(tcache[name][:, pages].numpy(),
                   np.asarray(jcache["blocks"][0][name])[:, pages])


def test_plan_for_flags_w8_as_the_reference():
    """``("w8", 1)`` on rmsnorm_matmul and the FFN stages, never on
    block_matmul; KV modes change no choice."""
    for arch in ARCHS:
        for red in (False, True):
            for mode in ("kv_fp8", "w8", "w8_kv8"):
                base, j_base = get_config(arch), j_get_config(arch)
                if red:
                    base, j_base = base.reduced(), j_base.reduced()
                cfg = dataclasses.replace(base, use_fused_kernels=True,
                                          quant=mode)
                j_cfg = dataclasses.replace(j_base, use_fused_kernels=True,
                                            quant=mode)
                for tokens, kv_len in ((4, 256), (20, 1024), (128, 1024)):
                    mine = plan_for(cfg, tokens, kv_len)
                    ref = j_plan_for(j_cfg, tokens, kv_len)
                    assert mine.quant == ref.quant == mode
                    lp, rlp = mine.layer("attn"), ref.layer("attn")
                    for stage in STAGES:
                        got, want = getattr(lp, stage), getattr(rlp, stage)
                        assert got.implementation == want.implementation
                        assert got.blocks == want.blocks, (arch, stage)


# ---------------------------------------------- pools and copies

def test_accounting_audits_value_scale_lockstep():
    _, t_cfg = _configs("llama3-8b", False, "kv_int8")
    kv = PagedKVCache(t_cfg, slots=1, max_len=32, page_size=8, device="cpu")
    cache = kv.init_cache()
    kv.assert_page_accounting(cache)
    assert cache["k"].dtype == torch.int8
    assert tuple(cache["k_scale"].shape) == (t_cfg.num_layers, kv.num_pages,
                                             t_cfg.num_kv_heads)
    del kv._defs["k_scale"]
    with pytest.raises(AssertionError, match="k_scale"):
        kv.assert_page_accounting()
    _, plain_cfg = _configs("llama3-8b", False)
    kv2 = PagedKVCache(plain_cfg, slots=1, max_len=32, page_size=8,
                       device="cpu")
    kv2._defs["k_scale"] = kv._defs["v_scale"]
    with pytest.raises(AssertionError, match="without kv quant"):
        kv2.assert_page_accounting()


def test_cow_copies_scale_rows_with_their_pages(weights):
    """The engine's copy-on-write duplicates a shared page in every pool,
    its scale rows included, in every layer (``engine.py:497``)."""
    _, tp = weights["llama3-8b"]
    _, t_cfg = _configs("llama3-8b", False, "kv_int8")
    eng = ServingEngine(t_cfg, tp, batch_slots=2, max_len=64, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for leaf in eng.cache.values():
        leaf.copy_((50 * torch.randn(leaf.shape, generator=gen))
                   .to(leaf.dtype))
    before = {n: t.clone() for n, t in eng.cache.items()}
    eng._copy_on_write(np.array([3, 0], np.int32), np.array([5, 0], np.int32))
    for name, leaf in eng.cache.items():
        assert torch.equal(leaf[:, 5], before[name][:, 3]), name
        keep = [p for p in range(leaf.shape[1]) if p != 5]
        assert torch.equal(leaf[:, keep], before[name][:, keep]), name
