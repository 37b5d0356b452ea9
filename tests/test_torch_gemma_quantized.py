"""gemma3-4b's quantized serving in the port on the CPU, against the JAX
package.

gemma3 runs five sliding-window layers to one global layer at head dim
320; under a quant mode its chunk, decode and verify attention read int8 /
fp8-e4m3 code pools (K9c, K9a, K9b) under the window, and its q/k/v and
GELU-GLU with ln2 folded in run on int8 weights (K10a, K10b).  Here, on
the reduced config (window 32, a global layer every 2, head dim 16),
float32, the JAX ``init_params`` jittered (the q/k norm scales start at
zero) and bridged with ``params_from_numpy``:

* the port's engine gives ``repro.serving.ServingEngine``'s greedy tokens
  and counters under w8_kv8 (chunked with the prefix cache on the kernel
  and eager plans, whole-prompt, speculative) and under kv_int8, kv_fp8
  and w8 (chunked, kernel plan);
* the port's accuracy gate gives the reference's for gemma3 in every
  quant mode;
* the plain K9a / K9b / K9c versions at head dim 320 under a window of
  64, at lengths window - 1, window, window + 1 and 200, equal the Pallas
  ``_q`` bodies in interpret mode (every K9b row K9a's at its length, bit
  for bit); the plain K10b with GELU and the norm folded in equals
  ``_ffn_kernel_w8``.

On the CPU the kernel plan runs each kernel's plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import flash_attention_2d as j_flash_2d
from repro.kernels import paged_decode_attention as j_paged_decode
from repro.kernels import paged_verify_attention as j_paged_verify
from repro.kernels import streamed_ffn as j_streamed_ffn
from repro.models import init_params as j_init_params
from repro.serving import ServingEngine as JServingEngine
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro.serving.accuracy import run_accuracy as j_run_accuracy
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import params_from_numpy
from repro_torch.serving import ServingEngine
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.accuracy import QUANT_MODES, run_accuracy

ARCH = "gemma3-4b"
REL = 1e-5
FP8 = torch.float8_e4m3fn
CODES = {"int8": torch.int8, "fp8": FP8}
COUNTERS = ("prefix_hit_pages", "prompt_pages", "draft_tokens",
            "accepted_tokens", "spec_tokens", "verify_dispatches",
            "rollbacks", "generated", "prefills", "prefill_chunks")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU runs here are many small ops: one intra-op thread
    each (restored after the module), so that the test workers running
    beside one another do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _to_jax(t: torch.Tensor):
    if t.dtype == FP8:
        return jnp.asarray(t.view(torch.uint8).numpy()
                           .view(ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.numpy())


def _configs(fused: bool):
    j_cfg = dataclasses.replace(j_get_config(ARCH).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                                use_fused_kernels=fused)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def weights():
    j_cfg, t_cfg = _configs(False)
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(1), j_cfg), seed=1)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                                 device="cpu")


def _burst(vocab: int):
    """Prompts of 150, 40, 300 and 9 tokens (most past the 32-token
    window), a repeat of the first (a prefix hit past the 128-token chunk)
    and a periodic prompt (n-gram drafts)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (150, 40, 300, 9)]
    return prompts + [prompts[0].copy(),
                      np.array([1, 2, 3, 4, 5, 6, 7, 8] * 5, np.int32)]


# ------------------------------------------------------------ the engine

ENGINES = {
    "chunked": dict(chunked=True),
    "whole_prompt": dict(chunked=False, prefix_cache=False),
    "speculative": dict(speculative=True, draft_len=4),
}
CASES = [("w8_kv8", "chunked", True), ("w8_kv8", "chunked", False),
         ("w8_kv8", "whole_prompt", True), ("w8_kv8", "speculative", True),
         ("kv_int8", "chunked", True), ("kv_fp8", "chunked", True),
         ("w8", "chunked", True)]


@pytest.mark.parametrize(
    "quant,mode,fused", CASES,
    ids=[f"{q}-{m}-{'kernel' if f else 'eager'}" for q, m, f in CASES])
def test_engine_greedy_tokens_equal_reference(weights, quant, mode, fused):
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    prompts = _burst(t_cfg.vocab_size)
    # 24 tokens for the speculative engine: the reduced model falls into a
    # cycle there, so drafts are accepted as well as rolled back.
    new = 24 if mode == "speculative" else 8
    kw = dict(batch_slots=4, max_len=384, quant=quant, **ENGINES[mode])
    ref = JServingEngine(j_cfg, jp, **kw)
    want = [r.out_tokens for r in ref.generate([p.copy() for p in prompts],
                                               max_new_tokens=new)]
    eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=new)
    assert [r.out_tokens for r in got] == want
    m, jm = eng.metrics, ref.metrics
    assert m["quant"] == jm["quant"] == quant
    assert {k: m[k] for k in COUNTERS} == {k: int(jm[k]) for k in COUNTERS}
    assert m["kv_itemsize_effective"] == pytest.approx(
        jm["kv_itemsize_effective"])
    assert m["generated"] == new * len(prompts) and m["pages_in_use"] == 0
    if mode == "chunked":
        assert m["prefix_hit_pages"] > 0
    if mode == "speculative":
        assert m["accepted_tokens"] > 0 and m["rollbacks"] > 0
    eng.kv.assert_page_accounting(eng.cache)


def test_accuracy_gate_matches_reference():
    """The port's teacher-forced gate on the reference's own weights gives
    its tokens, tokens_equal, max_logit_err (within 1e-4) and KV item size
    in every quant mode."""
    want = j_run_accuracy(ARCH, modes=QUANT_MODES, steps=6)
    j_cfg, t_cfg = _configs(False)
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(0), j_cfg), seed=0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg, device="cpu")
    got = run_accuracy(ARCH, modes=QUANT_MODES, steps=6, params=tp,
                       device="cpu")
    assert got["none"]["tokens"] == want["none"]["tokens"]
    for mode in QUANT_MODES:
        assert got[mode]["tokens_equal"] == want[mode]["tokens_equal"]
        assert got[mode]["max_logit_err"] == pytest.approx(
            want[mode]["max_logit_err"], abs=1e-4)
        assert got[mode]["kv_itemsize"] == pytest.approx(
            want[mode]["kv_itemsize"])


# --------------------------- plain kernel versions at D = 320, windowed

D, WINDOW = 320, 64
LENGTHS = (WINDOW - 1, WINDOW, WINDOW + 1, 200)


def _code_pools(rng, code, b, hkv, ps=16, maxp=16):
    """K/V code pools of 1 + b * maxp pages with per-(page, KV head)
    scales, and a shuffled page table."""
    pages = 1 + b * maxp
    dt = CODES[code]
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((pages, ps, hkv, D))
                             .astype(np.float32))
        s = x.abs().amax(dim=(1, 3)) / tkv.kv_quant_qmax(dt)
        out += [tkv.quantize_kv(x, s[:, None, :, None], dt), s]
    table = torch.from_numpy((rng.permutation(pages - 1) + 1).reshape(
        b, maxp).astype(np.int32))
    return (*out, table)


@pytest.mark.parametrize("code", sorted(CODES))
def test_paged_twins_with_a_window_at_head_dim_320_match_pallas(code):
    """K9a over slots at the window's edge lengths and an idle one; K9b
    with five rows a slot across them, each row K9a's at its length."""
    rng = np.random.default_rng(30)
    b, w, hq, hkv = len(LENGTHS), 5, 8, 4
    kp, ks, vp, vs, table = _code_pools(rng, code, b + 1, hkv)
    sc = dict(k_scale=ks, v_scale=vs)
    jargs = dict(k_scale=_to_jax(ks), v_scale=_to_jax(vs), window=WINDOW,
                 interpret=True)
    lengths = torch.tensor(LENGTHS + (0,), dtype=torch.int32)
    q = torch.from_numpy(0.3 * rng.standard_normal((b + 1, w, hq, D))
                         .astype(np.float32))
    q1 = q[:, :1].contiguous()
    K.reset_launches()
    dec = K.paged_decode_attention_q(q1, kp, vp, table, lengths,
                                     window=WINDOW, **sc)
    _rel_close(dec.numpy(), j_paged_decode(
        _to_jax(q1), _to_jax(kp), _to_jax(vp), _to_jax(table),
        _to_jax(lengths), **jargs))
    assert torch.count_nonzero(dec[-1]) == 0
    q_off = torch.tensor([n - 3 for n in LENGTHS] + [0], dtype=torch.int32)
    ver = K.paged_verify_attention_q(q, kp, vp, table, q_off,
                                     window=WINDOW, **sc)
    _rel_close(ver.numpy(), j_paged_verify(
        _to_jax(q), _to_jax(kp), _to_jax(vp), _to_jax(table),
        _to_jax(q_off), **jargs))
    for i in range(w):
        row = K.paged_decode_attention_q(
            q[:, i:i + 1].contiguous(), kp, vp, table, q_off + i + 1,
            window=WINDOW, **sc)
        assert torch.equal(ver[:, i:i + 1], row), i
    assert all(n == 0 for n in K.launch_counts().values())   # CPU: plain


@pytest.mark.parametrize("code", sorted(CODES))
@pytest.mark.parametrize("kv_len", LENGTHS)
def test_flash_twin_with_a_window_at_head_dim_320_matches_pallas(kv_len,
                                                                 code):
    """K9c: a 16-row chunk ending at ``kv_len`` over 256 gathered code
    positions with per-position scales, 8 query heads over 4."""
    rng = np.random.default_rng(kv_len + 31)
    hkv, g, sq, skv = 4, 2, 16, 256
    dt = CODES[code]
    x = torch.from_numpy(rng.standard_normal((2, hkv, skv, D))
                         .astype(np.float32))
    pos_scale = x.abs().amax(dim=-1) / tkv.kv_quant_qmax(dt)   # [2,Hkv,Skv]
    k, v = (tkv.quantize_kv(x[i], pos_scale[i][..., None], dt)
            for i in range(2))
    q = torch.from_numpy(0.3 * rng.standard_normal((hkv * g, sq, D))
                         .astype(np.float32))
    q_off = kv_len - sq
    got = K.flash_attention_2d_q(q, k, v, k_scale=pos_scale[0],
                                 v_scale=pos_scale[1], q_offset=q_off,
                                 kv_len=kv_len, kv_group=g, window=WINDOW,
                                 block_kv=32)
    want = j_flash_2d(_to_jax(q), _to_jax(k), _to_jax(v), q_offset=q_off,
                      kv_len=kv_len, kv_group=g, window=WINDOW, block_q=16,
                      block_kv=32, k_scale=_to_jax(pos_scale[0]),
                      v_scale=_to_jax(pos_scale[1]), interpret=True)
    _rel_close(got.numpy(), want)


@pytest.mark.parametrize("t", [4, 20])
def test_w8_ffn_gelu_with_the_norm_folded_in_matches_pallas(t):
    """K10b's GELU-GLU with ln2 folded in (gemma3's FFN) against the
    interpret-mode ``_ffn_kernel_w8``, with a zero output column."""
    rng = np.random.default_rng(40 + t)
    d, f = 64, 256

    def q8(*shape):
        w = rng.standard_normal(shape).astype(np.float32) / np.sqrt(shape[0])
        w[:, 1] = 0.0
        return L.quantize_channelwise(torch.from_numpy(w))

    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    s = torch.from_numpy(0.1 * rng.standard_normal(d).astype(np.float32))
    (cg, sg), (cu, su), (cd, sd) = q8(d, f), q8(d, f), q8(f, d)
    got = K.streamed_ffn_w8(x, cg, cu, cd, wg_scale=sg, wu_scale=su,
                            wd_scale=sd, norm_scale=s, activation="gelu")
    want = j_streamed_ffn(_to_jax(x), _to_jax(cg), _to_jax(cu), _to_jax(cd),
                          norm_scale=_to_jax(s), wg_scale=_to_jax(sg),
                          wu_scale=_to_jax(su), wd_scale=_to_jax(sd),
                          activation="gelu", block_f=32, interpret=True)
    _rel_close(got.numpy(), want)
