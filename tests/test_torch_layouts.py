"""The ``bhsd`` KV cache layout in the port on the CPU, against the JAX
package.

Under ``kv_cache_layout="bhsd"`` the contiguous K/V leaves are [L_attn, B,
Hkv, S, hd] and the K/V a step writes are transposed at the edges; the
paged pools stay page-major [L, P, ps, Hkv, hd], so the paged kernels see
the same pools under either layout.  On llama3-8b.reduced():

* the page primitives (append, window append, chunk placement, gather,
  whole-prompt placement) bit-equal to ``repro.serving.kv_cache`` under
  "bhsd", and a "bhsd" pool equal to the "bshd" one;
* ``prefill``'s collected K/V: "bhsd" equal to the port's "bshd" K/V
  transposed, and to the reference's "bhsd" K/V at the bf16 level in
  bfloat16 (eager plan); ``decode_step`` without a table against the
  reference's "bhsd" decode at its own bf16-level tolerance (5e-2: the
  scores are emitted in the cache dtype,
  ``tests/test_models_smoke.py:188-190``) in bfloat16 (eager plan) and at
  relative 1e-5 in float32 (kernel plan);
* the engine's greedy tokens under "bhsd" exactly equal to
  ``repro.serving.ServingEngine``'s under "bhsd", paged (chunked with the
  prefix cache, kernel and eager plans) and contiguous, float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.serving import ServingEngine as JServingEngine
from repro.serving import kv_cache as jkv
from repro.serving.engine import _place_cache_slot as j_place_cache_slot
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, init_cache, params_from_numpy,
                                prefill)
from repro_torch.serving import ServingEngine
from repro_torch.serving import kv_cache as tkv
from repro_torch.serving.engine import _place_cache_slot

ARCH = "llama3-8b"
BURST = (40, 5, 75, 21)
BF16_TOL = 5e-2
REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small CPU ops: one intra-op thread (restored after the
    module), so that test workers beside one another do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(layout, dtype="float32", fused=True):
    kw = dict(dtype=dtype, use_fused_kernels=fused, kv_cache_layout=layout)
    return (dataclasses.replace(j_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


_WEIGHTS = {}


def _weights(dtype):
    if dtype not in _WEIGHTS:
        j_cfg, t_cfg = _configs("bshd", dtype)
        jp = j_init_params(jax.random.PRNGKey(4), j_cfg)
        _WEIGHTS[dtype] = (jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), t_cfg, device="cpu"))
    return _WEIGHTS[dtype]


def _t(a):
    return torch.from_numpy(np.array(a))


def test_page_primitives_bit_equal_reference_under_bhsd():
    rng = np.random.default_rng(6)
    pages, ps, h, d, b = 9, 4, 2, 3, 2
    pool = rng.standard_normal((pages, ps, h, d)).astype(np.float32)
    table = np.array([[3, 5, 0, 0], [7, 1, 2, 0]], np.int32)
    pos = np.array([6, 16], np.int32)                   # slot 1 past extent
    new = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    want = jkv.paged_append(jnp.asarray(pool), table, pos, new,
                            layout="bhsd")
    got = tkv.paged_append(_t(pool), _t(table), _t(pos), _t(new),
                           layout="bhsd")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bshd = tkv.paged_append(_t(pool), _t(table), _t(pos),
                            _t(new.transpose(0, 2, 1, 3)), layout="bshd")
    np.testing.assert_array_equal(got.numpy(), bshd.numpy())
    np.testing.assert_array_equal(
        tkv.gather_pages(got, _t(table), layout="bhsd").numpy(),
        np.asarray(jkv.gather_pages(want, table, layout="bhsd")))
    win = rng.standard_normal((b, h, 3, d)).astype(np.float32)
    np.testing.assert_array_equal(
        tkv.paged_append_window(_t(pool), _t(table), _t(pos), _t(win),
                                layout="bhsd").numpy(),
        np.asarray(jkv.paged_append_window(jnp.asarray(pool), table, pos,
                                           win, layout="bhsd")))
    seq = rng.standard_normal((1, h, 8, d)).astype(np.float32)
    cp = np.array([4, 6], np.int32)
    np.testing.assert_array_equal(
        tkv.place_chunk_pages(_t(pool), _t(seq), _t(cp),
                              layout="bhsd").numpy(),
        np.asarray(jkv.place_chunk_pages(jnp.asarray(pool), seq, cp,
                                         layout="bhsd")))
    fresh = rng.standard_normal((2, 1, h, 7, d)).astype(np.float32)
    pools = np.stack([pool, pool])
    placed = tkv.place_prefill({"k": _t(pools)}, {"k": _t(fresh)},
                               _t(np.array([2, 8], np.int32)),
                               layout="bhsd", slot=0)["k"]
    ref = jkv.place_prefill(
        {"blocks": ({"k": jnp.asarray(pools)},), "rest": ()},
        {"blocks": ({"k": jnp.asarray(fresh)},), "rest": ()},
        jnp.int32(0), jnp.asarray([2, 8], jnp.int32), layout="bhsd")
    np.testing.assert_array_equal(placed.numpy(),
                                  np.asarray(ref["blocks"][0]["k"]))


def test_prefill_kv_under_bhsd_matches_reference():
    jp, tp = _weights("bfloat16")
    tokens = np.random.default_rng(2).integers(0, 256, (2, 24)).astype(
        np.int32)
    got = {}
    for layout in ("bshd", "bhsd"):
        _, t_cfg = _configs(layout, "bfloat16", fused=False)
        _, got[layout] = prefill(tp, t_cfg, torch.as_tensor(tokens))
    j_cfg, t_cfg = _configs("bhsd", "bfloat16", fused=False)
    _, want = j_prefill(jp, j_cfg, {"tokens": jnp.asarray(tokens)})
    for name in ("k", "v"):
        t = got["bhsd"][name]
        assert tuple(t.shape) == (t_cfg.num_layers, 2, t_cfg.num_kv_heads,
                                  24, t_cfg.head_dim_)
        assert torch.equal(t, got["bshd"][name].transpose(2, 3))
        ref = np.concatenate([np.asarray(blk[name], np.float32)
                              for blk in want["blocks"]], axis=0)
        np.testing.assert_allclose(t.float().numpy(), ref, atol=BF16_TOL,
                                   rtol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_step_under_bhsd_matches_reference(dtype):
    jp, tp = _weights(dtype)
    # The kernel plan in float32; the bf16 case is about the layout's
    # score rounding, which the eager plan shows at less cost.
    j_cfg, t_cfg = _configs("bhsd", dtype, fused=dtype == "float32")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (19, 6)]
    j_cache = j_init_cache(j_cfg, 2, 32)
    t_cache = init_cache(t_cfg, 2, 32, device="cpu")
    for slot, p in enumerate(prompts):
        _, fresh = j_prefill(jp, j_cfg, {"tokens": jnp.asarray(p)[None]})
        j_cache = j_place_cache_slot(j_cache, fresh, jnp.int32(slot))
        _, tfresh = prefill(tp, t_cfg, torch.as_tensor(p)[None])
        _place_cache_slot(t_cache, tfresh, slot, "bhsd")
    assert tuple(t_cache["k"].shape[2:4]) == (t_cfg.num_kv_heads, 32)
    pos = np.array([19, 6], np.int32)
    tok = np.array([[3], [9]], np.int32)
    for _ in range(2):
        jt, jl, j_cache = j_decode_step(jp, j_cfg, jnp.asarray(tok), j_cache,
                                        jnp.asarray(pos), jnp.asarray(pos))
        _, tl, _ = decode_step(tp, t_cfg, torch.as_tensor(tok), t_cache,
                               torch.as_tensor(pos), torch.as_tensor(pos))
        want = np.asarray(jl, np.float64)
        got = tl.numpy().astype(np.float64)
        if dtype == "float32":
            assert np.abs(got - want).max() <= REL * np.abs(want).max()
        else:
            np.testing.assert_allclose(got, want, atol=BF16_TOL,
                                       rtol=BF16_TOL)
        tok = np.array(jt)
        pos = pos + 1


ENGINES = {"paged-kernel": (True, dict()),
           "paged-eager": (False, dict()),
           "contiguous": (True, dict(paged=False))}


@pytest.mark.parametrize("mode", list(ENGINES))
def test_engine_tokens_under_bhsd_equal_reference(mode):
    jp, tp = _weights("float32")
    fused, kw = ENGINES[mode]
    j_cfg, t_cfg = _configs("bhsd", "float32", fused)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in BURST]
    prompts.append(prompts[2].copy())   # a prefix hit on the eager plan
    kw = dict(batch_slots=3, max_len=96, **kw)
    ref = JServingEngine(j_cfg, jp, **kw)
    want = ref.generate(prompts, max_new_tokens=6)
    eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=6)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    if eng.kv is not None:
        assert (eng.metrics["prefix_hit_pages"]
                == ref.metrics["prefix_hit_pages"])
        eng.kv.assert_page_accounting(eng.cache)
        assert tuple(eng.cache["k"].shape[3:]) == (t_cfg.num_kv_heads,
                                                   t_cfg.head_dim_)
