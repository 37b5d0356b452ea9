"""Serving rwkv6 in the port on the CPU, against the JAX package.

``rwkv6-7b`` reduced (2 RWKV6 layers, 4 heads of 16), float32, weights
from the JAX ``init_params`` jittered (``repro.serving.accuracy.
jitter_params``: LayerNorm scales start at zero and the token-shift mixes
at one, which would zero every logit and hide the shift) and bridged
through ``params_from_numpy``; kernel and eager plans (on the CPU the
kernel plan runs K14's plain version):

* ``prefill``: the logits and every state leaf (``wkv``, ``tm_shift``,
  ``cm_shift``) at relative 1e-5;
* whole-prompt placement of two prompts into the port's paged cache (no
  K/V pools) and the reference's contiguous cache, then 6 ``decode_step``s
  (one slot idle for the first three): logits at 1e-5, tokens equal, the
  state rows after the last step (the shifts held in bfloat16 by both
  packages, whatever the compute dtype);
* ``ServingEngine`` greedy tokens and counters against
  ``repro.serving.ServingEngine(paged=False)`` on a mixed burst of 5
  prompts over 2 slots (the reference's paged engine cannot be built for
  an attention-free stack), both plans; ``quant="w8"`` gives the plain
  tokens; the KV quant modes, chunked prefill, speculative decoding and
  the prefix cache are refused; the accuracy gate refuses the config.
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
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro.serving.engine import _place_cache_slot as j_place_cache_slot
from repro_torch.configs import get_config
from repro_torch.models import decode_step, params_from_numpy, prefill
from repro_torch.serving import PagedKVCache, ServingEngine
from repro_torch.serving import accuracy as taccuracy
from repro_torch.serving import kv_cache as tkv


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
STATE = ("wkv", "tm_shift", "cm_shift")
COUNTERS = ("generated", "ticks", "scan_ticks", "dispatches", "prefills",
            "prefill_chunks", "rejected", "prefix_hit_pages",
            "prompt_pages", "kv_bytes_peak", "kv_itemsize_effective")


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
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(0), j_cfg), seed=0)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                                 device="cpu")


def _j_state(cache, name):
    """The reference cache's ``name`` leaf in the port's [L, B, ...]
    layout (every rwkv6 layer sits in pattern group 0)."""
    return np.asarray(cache["blocks"][0][name])


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
def test_prefill_matches_reference(weights, fused):
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    tokens = np.random.default_rng(3).integers(
        0, t_cfg.vocab_size, (2, 37)).astype(np.int32)
    jl, jc = j_prefill(jp, j_cfg, {"tokens": jnp.asarray(tokens)})
    tl, tc = prefill(tp, t_cfg, torch.from_numpy(tokens))
    _rel_close(tl.numpy(), jl)
    assert sorted(tc) == sorted(STATE)
    assert tc["wkv"].shape == (2, 2, 4, 16, 16)
    assert tc["wkv"].dtype == torch.float32
    for name in STATE:
        _rel_close(tc[name].numpy(), _j_state(jc, name))


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
def test_placed_prefill_then_decode_matches_reference(weights, fused):
    """Prompts of 20 and 5 tokens placed into slots 0 and 1 (slot 1
    admitted after three steps, idle before), then 6 decode steps."""
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    slots, max_len = 2, 64
    tk = PagedKVCache(t_cfg, slots=slots, max_len=max_len, page_size=16,
                      device="cpu")
    jcache, tcache = j_init_cache(j_cfg, slots, max_len), tk.init_cache()
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, t_cfg.vocab_size, n).astype(np.int32)
               for n in (20, 5)]
    tok = np.zeros((slots, 1), np.int32)
    pos = np.array([0, tk.extent], np.int32)
    lengths = np.zeros(slots, np.int32)

    def admit(slot):
        nonlocal jcache
        p = prompts[slot]
        pages = tk.ensure(slot, len(p))
        jl, fresh = j_prefill(jp, j_cfg, {"tokens": jnp.asarray(p)[None]})
        jcache = j_place_cache_slot(jcache, fresh, jnp.int32(slot))
        tl, tfresh = prefill(tp, t_cfg, torch.from_numpy(p)[None])
        tkv.place_prefill(tcache, tfresh, torch.from_numpy(pages),
                          layout=t_cfg.kv_cache_layout, slot=slot)
        _rel_close(tl.numpy(), jl)
        tok[slot, 0] = int(tl[0, 0].argmax())
        pos[slot] = lengths[slot] = len(p)

    admit(0)
    for step in range(6):
        if step == 3:
            admit(1)
        for s in range(slots):
            if lengths[s]:
                tk.ensure(s, int(pos[s]) + 1)
        jt, jl, jcache = j_decode_step(jp, j_cfg, tok, jcache, pos, lengths)
        tt, tl, tcache = decode_step(
            tp, t_cfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos),
            torch.from_numpy(lengths), page_table=tk.page_table)
        live = lengths > 0
        _rel_close(tl.numpy()[live], np.asarray(jl)[live])
        np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])
        tok = tt.numpy().copy()
        pos = np.where(live, pos + 1, pos)
        lengths = np.where(live, lengths + 1, 0).astype(np.int32)
    assert tcache["tm_shift"].dtype == torch.bfloat16
    assert _j_state(jcache, "tm_shift").dtype == jnp.bfloat16
    for name in STATE:
        _rel_close(tcache[name].float().numpy(),
                   _j_state(jcache, name).astype(np.float32))
    tk.assert_page_accounting(tcache)


ENGINE_CASES = [("none", True), ("none", False), ("w8", True)]


@pytest.mark.parametrize("quant,fused", ENGINE_CASES,
                         ids=[f"{q}-{'kernel' if f else 'eager'}"
                              for q, f in ENGINE_CASES])
def test_engine_greedy_tokens_equal_reference(weights, quant, fused):
    """A mixed burst with more requests than slots; the reference serves
    it without quantization (its contiguous engine refuses none of it,
    and no rwkv6 stage has a w8 twin, so ``w8`` must give these tokens)."""
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, t_cfg.vocab_size, n).astype(np.int32)
               for n in (5, 37, 20, 9, 64)]
    ref = JServingEngine(j_cfg, jp, batch_slots=2, max_len=128, paged=False)
    want = [r.out_tokens for r in ref.generate([p.copy() for p in prompts],
                                               max_new_tokens=8)]
    eng = ServingEngine(t_cfg, tp, batch_slots=2, max_len=128, quant=quant,
                        device="cpu")
    got = eng.generate(prompts, max_new_tokens=8)
    assert [r.out_tokens for r in got] == want
    assert len({tuple(t) for t in want}) > 1       # the prompts matter
    assert eng.chunked is False and eng.prefix is None
    m, jm = eng.metrics, ref.metrics
    assert {k: m[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert m["generated"] == 40 and m["prefills"] == 5
    assert m["quant"] == quant
    eng.kv.assert_page_accounting(eng.cache)


def test_engine_and_gate_refuse_what_rwkv6_cannot_serve(weights):
    _, tp = weights
    _, t_cfg = _configs(True)
    for mode in ("kv_int8", "kv_fp8", "w8_kv8"):
        with pytest.raises(ValueError, match="no K/V pools"):
            ServingEngine(t_cfg, tp, quant=mode, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(t_cfg, tp, chunked=True, device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        ServingEngine(t_cfg, tp, speculative=True, device="cpu")
    with pytest.raises(ValueError, match="prefix_cache requires"):
        ServingEngine(t_cfg, tp, prefix_cache=True, device="cpu")
    assert not taccuracy.supports_quantized_serving(t_cfg)
    with pytest.raises(ValueError, match="cannot serve quantized"):
        taccuracy.run_accuracy(ARCH, device="cpu")
