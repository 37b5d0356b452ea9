"""The port's MoE slice (granite-moe) on the CPU, against the JAX package.

* K12's plain version (``ref.moe_experts``) against the interpret-mode
  Pallas ``moe_experts_pallas`` at relative 1e-5 in float32, over (E,
  top-k) in {(4, 2), (8, 8), (32, 8)} and a case whose gate rows hold tied
  probabilities (the threshold keeps more than k experts), and in bfloat16
  at the card check's bf16 tolerance (2e-2); the wrapper on a CPU tensor
  runs the plain version and launches nothing.
* The row-norm kernel's RMSNorm mode (ln2) against the eager RMSNorm.
* The router (``moe_gates``) against ``repro.models.layers.moe_gates``:
  the same experts kept in every row, ties included, and the gate values
  at relative 1e-6 (the two frameworks' float32 ``exp`` differ by an ulp,
  so the softmax cannot match bit for bit).
* The configs, the MoE parameter leaves through the numpy bridge (both
  ways, bit for bit), and the plan pinned to the reference ``plan_for``.
* ``prefill``, ``prefill_chunk``, ``decode_step`` and ``verify_step``
  logits against ``repro.models`` at relative 1e-5, both granite configs
  reduced, kernel and eager plans.

Float32 weights from the JAX ``init_params``, bridged with
``params_from_numpy``; other inputs numpy-seeded.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.stream_plan import plan_for as j_plan_for
from repro.kernels.moe_experts import moe_experts_pallas
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.models import prefill as j_prefill
from repro.models import prefill_chunk as j_prefill_chunk
from repro.models import verify_step as j_verify_step
from repro.serving import PagedKVCache as JPagedKVCache
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.core.stream_plan import STAGES, plan_for
from repro_torch.kernels import ref
from repro_torch.models import (decode_step, layers as L, model_defs,
                                params_from_numpy, params_to_numpy, prefill,
                                prefill_chunk, verify_step)
from repro_torch.models.params import tree_leaves
from repro_torch.serving import PagedKVCache
from repro_torch.serving.kv_cache import stage_chunk

REL = 1e-5
ARCHS = ("granite-moe-1b-a400m", "granite-moe-3b-a800m")


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _configs(arch: str, fused: bool):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                use_fused_kernels=fused)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        j_cfg, t_cfg = _configs(arch, False)
        jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
        out[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           t_cfg, device="cpu"))
    return out


# ------------------------------------------------------ K12 and gates

def _moe_case(rng, e, top_k, ties=False, t=24, d=32, f=48):
    """x, gates (the reference router's, from numpy logits) and experts.
    ``ties``: every row's logits hold four equal top values (and a second
    tied group), so ``probs >= thresh`` keeps more than ``top_k``."""
    x = _rand(rng, t, d)
    logits = _rand(rng, t, e)
    if ties:
        logits[:, :4] = logits[:, :4].max(axis=1, keepdims=True) + 1.0
        logits[:, 4:6] = -5.0
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    thresh = jax.lax.top_k(probs, top_k)[0][:, -1:]
    gates = jnp.where(probs >= thresh, probs, 0.0)
    gates = np.asarray(gates / gates.sum(-1, keepdims=True))
    ws = (_rand(rng, e, d, f, scale=d ** -0.5),
          _rand(rng, e, d, f, scale=d ** -0.5),
          _rand(rng, e, f, d, scale=f ** -0.5))
    return x, gates, ws


MOE_CASES = [(4, 2, False), (8, 8, False), (32, 8, False), (8, 2, True)]
MOE_IDS = ["e4k2", "e8k8", "e32k8", "ties"]


@pytest.mark.parametrize("e,top_k,ties", MOE_CASES, ids=MOE_IDS)
def test_moe_experts_plain_matches_pallas(e, top_k, ties):
    x, gates, (wg, wu, wd) = _moe_case(np.random.default_rng(e), e, top_k,
                                       ties)
    if ties:
        assert ((gates > 0).sum(axis=1) > top_k).all()
    want = moe_experts_pallas(*(jnp.asarray(a) for a in (x, gates, wg, wu,
                                                         wd)),
                              block_t=8, interpret=True)
    K.reset_launches()
    got = K.moe_experts(*(torch.from_numpy(a) for a in (x, gates, wg, wu,
                                                        wd)))
    assert K.moe_experts.launches == 0                 # CPU: plain version
    _rel_close(got.numpy(), want)


@pytest.mark.parametrize("e,top_k,ties", MOE_CASES, ids=MOE_IDS)
def test_moe_experts_plain_matches_pallas_bf16(e, top_k, ties):
    """The experts in bfloat16: h rounded to bf16 before the down
    product, as the Pallas kernel does."""
    x, gates, (wg, wu, wd) = _moe_case(np.random.default_rng(e), e, top_k,
                                       ties)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (x, gates, wg, wu, wd)]
    want = np.asarray(moe_experts_pallas(*args, block_t=8, interpret=True)
                      .astype(jnp.float32))
    got = ref.moe_experts(*(torch.from_numpy(np.asarray(a, np.float32))
                            .bfloat16() for a in args))
    assert got.dtype == torch.bfloat16
    _rel_close(got.float().numpy(), want, 2e-2)


def test_moe_experts_refuses_bad_shapes_and_activation():
    x, gates, (wg, wu, wd) = _moe_case(np.random.default_rng(1), 4, 2)
    t = [torch.from_numpy(a) for a in (x, gates, wg, wu, wd)]
    with pytest.raises(ValueError, match="moe_experts"):
        K.moe_experts(t[0], t[1][:, :3], *t[2:])
    with pytest.raises(ValueError, match="activation"):
        K.moe_experts(*t, activation="relu")
    # The plain version covers GELU (the CUDA kernel refuses it).
    want = moe_experts_pallas(*(jnp.asarray(a) for a in (x, gates, wg, wu,
                                                         wd)),
                              activation="gelu", block_t=8, interpret=True)
    _rel_close(K.moe_experts(*t, activation="gelu").numpy(), want)


def test_rms_norm_rows_is_the_eager_rms_norm_and_the_reference():
    """The row-norm kernel's RMSNorm mode (granite's ln2 on the serving
    path): its plain version is ``layers.rms_norm`` bit for bit and the
    reference's ``rms_norm`` at 1e-6."""
    rng = np.random.default_rng(5)
    x, s = _rand(rng, 24, 32), _rand(rng, 32, scale=0.1)
    K.reset_launches()
    got = K.rms_norm_rows(torch.from_numpy(x), torch.from_numpy(s))
    assert K.rms_norm_rows.launches == 0               # CPU: plain version
    assert torch.equal(got, L.rms_norm(torch.from_numpy(x),
                                       torch.from_numpy(s)))
    _rel_close(got.numpy(), JL.rms_norm(jnp.asarray(x), jnp.asarray(s)),
               1e-6)
    with pytest.raises(ValueError, match="rms_norm_rows"):
        K.rms_norm_rows(torch.from_numpy(x), torch.from_numpy(s[:8]))


@pytest.mark.parametrize("e,top_k,ties", MOE_CASES, ids=MOE_IDS)
def test_moe_gates_match_reference(e, top_k, ties):
    rng = np.random.default_rng(30 + e)
    d = 32
    x = _rand(rng, 24, d)
    wr = _rand(rng, d, e, scale=d ** -0.5)
    if ties:                   # duplicate router columns: tied logits
        wr[:, 1] = wr[:, 0]
        wr[:, 2] = wr[:, 0]
        x[0] = 0.0             # an all-zero row: every expert ties
    want = np.asarray(JL.moe_gates(jnp.asarray(x), jnp.asarray(wr), top_k))
    got = L.moe_gates(torch.from_numpy(x), torch.from_numpy(wr),
                      top_k).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    if ties:
        assert (got > 0).sum(axis=1).max() > top_k
        assert (got[0] > 0).all()
    _rel_close(got, want, 1e-6)


# ------------------------------------------- configs, params, plan

def test_configs_match_reference():
    for arch in ARCHS:
        for j_cfg, t_cfg in ((j_get_config(arch), get_config(arch)),
                             (j_get_config(arch).reduced(),
                              get_config(arch).reduced())):
            assert dataclasses.asdict(j_cfg) == dataclasses.asdict(t_cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_bridge_carries_moe_leaves_both_ways(weights, arch):
    jp, tp = weights[arch]
    _, t_cfg = _configs(arch, False)
    mlp = model_defs(t_cfg)["layers"][0]["mlp"]
    assert list(mlp) == ["wr", "wu", "wd", "wg"]     # ``_ffn_defs`` order
    assert set(mlp) == set(jp["blocks"][0]["mlp"])
    e, d, f = t_cfg.num_experts, t_cfg.d_model, t_cfg.d_ff
    assert {n: pd.shape for n, pd in mlp.items()} == {
        "wr": (d, e), "wu": (e, d, f), "wd": (e, f, d), "wg": (e, d, f)}
    for i, layer in enumerate(tp["layers"]):
        for name in mlp:
            np.testing.assert_array_equal(
                layer["mlp"][name].numpy(),
                np.asarray(jp["blocks"][0]["mlp"][name][i]))
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
    if arch.endswith("-reduced"):
        base, j_base = base.reduced(), j_base.reduced()
    for quant in ("none", "w8_kv8"):
        cfg = dataclasses.replace(base, use_fused_kernels=True, quant=quant)
        j_cfg = dataclasses.replace(j_base, use_fused_kernels=True,
                                    quant=quant)
        for tokens in (4, 20, 128, 2048):
            mine, want = plan_for(cfg, tokens, 2048), j_plan_for(
                j_cfg, tokens, 2048)
            lp, rlp = mine.layer("attn"), want.layer("attn")
            for stage in STAGES:
                got, exp = getattr(lp, stage), getattr(rlp, stage)
                assert (got.implementation, got.blocks) == (
                    exp.implementation, exp.blocks), (stage, tokens, quant)
            assert (mine.lm_head.implementation, mine.lm_head.blocks) == (
                want.lm_head.implementation, want.lm_head.blocks)
            ps = mine.decode_page_size()
            assert ps == want.decode_page_size()
            assert mine.prefill_chunk_size(ps) == want.prefill_chunk_size(ps)
    assert plan_for(base, 4, 256) is None          # eager config


# ----------------------------------------------------- entry points

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
@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_decode_and_verify_match_reference(weights, arch, fused):
    """Two prefill chunks of a 100-token prompt into slot 0, two decode
    steps with slot 1 idle, then a 5-row verify window."""
    jp, tp = weights[arch]
    j_cfg, t_cfg = _configs(arch, fused)
    slots, max_len, ps, chunk, w = 2, 160, 16, 64, 5
    jkv = JPagedKVCache(j_cfg, slots=slots, max_len=max_len, page_size=ps)
    tkv = PagedKVCache(t_cfg, slots=slots, max_len=max_len, page_size=ps,
                       device="cpu")
    jcache, tcache = jkv.init_cache(), tkv.init_cache()
    rng = np.random.default_rng(4)
    plen = 100
    prompt = rng.integers(0, t_cfg.vocab_size, plen).astype(np.int32)
    for off in (0, chunk):
        for kc in (jkv, tkv):
            kc.ensure(0, min(off + chunk, max_len))
        row = tkv.table_row(0)
        toks, cpages, last = stage_chunk(prompt, off, chunk, row, ps)
        jt, jl, jcache = j_prefill_chunk(jp, j_cfg, toks[None], jcache, row,
                                         cpages, off, last)
        tt, tl, tcache = prefill_chunk(
            tp, t_cfg, torch.from_numpy(toks)[None], tcache,
            torch.from_numpy(row), torch.from_numpy(cpages), off, last)
        _rel_close(tl.numpy(), jl)
        assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])
    tok = np.array([[int(tt[0, 0])], [0]], np.int32)
    pos = np.array([plen, tkv.extent], np.int32)
    lengths = np.array([plen, 0], np.int32)
    for _ in range(2):
        for kc in (jkv, tkv):
            kc.ensure(0, int(pos[0]) + 1)
        jt, jl, jcache = j_decode_step(jp, j_cfg, tok, jcache, pos, lengths,
                                       page_table=jkv.page_table)
        tt, tl, tcache = decode_step(
            tp, t_cfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos),
            torch.from_numpy(lengths), page_table=tkv.page_table)
        _rel_close(tl.numpy()[0], np.asarray(jl)[0])
        assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])
        tok = tt.numpy().copy()
        pos, lengths = pos + 1, lengths + 1
    window = np.zeros((slots, w), np.int32)
    window[0, 0] = tok[0, 0]
    window[0, 1:] = rng.integers(0, t_cfg.vocab_size, w - 1)
    lengths[1] = 0
    for kc in (jkv, tkv):
        kc.ensure(0, int(pos[0]) + w)
    jg, jl, jcache = j_verify_step(jp, j_cfg, window, jcache, pos, lengths,
                                   page_table=jkv.page_table)
    tg, tl, tcache = verify_step(
        tp, t_cfg, torch.from_numpy(window), tcache, torch.from_numpy(pos),
        torch.from_numpy(lengths), page_table=tkv.page_table)
    _rel_close(tl.numpy()[0], np.asarray(jl)[0])
    np.testing.assert_array_equal(tg.numpy()[0], np.asarray(jg)[0])
