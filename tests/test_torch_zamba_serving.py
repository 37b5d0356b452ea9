"""Serving zamba2 in the port on the CPU, against the JAX package.

``zamba2-2.7b`` reduced (4 Mamba2 layers, the shared attention+MLP block
after layers 1 and 3), float32, weights from the JAX ``init_params``
through ``params_from_numpy``; kernel and eager plans (on the CPU the
kernel plan runs each kernel's plain version):

* ``prefill``: the logits and every cache leaf (``ssm``, ``conv``, and the
  K/V of the two shared-block applications) at relative 1e-5;
* whole-prompt placement of two prompts into a paged cache, then 6
  ``decode_step``s (one slot idle for the first three): logits at 1e-5,
  the state rows after the last step (the conv tail held in bfloat16 by
  both packages, whatever the compute dtype);
* ``ServingEngine`` greedy tokens against ``repro.serving.ServingEngine``
  on prompts of 5, 37 and 20 tokens over 2 slots, plain and under
  ``kv_int8`` and ``w8_kv8`` on the kernel plan (plain also on the eager
  plan), with equal counters; the engine admits whole prompts, keeps the
  prefix cache off by default, and refuses chunked prefill and
  speculative decoding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.serving import PagedKVCache as JPagedKVCache
from repro.serving import ServingEngine as JServingEngine
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config
from repro_torch.models import decode_step, params_from_numpy, prefill
from repro_torch.serving import PagedKVCache, ServingEngine
from repro_torch.serving import kv_cache as tkv

REL = 1e-5
ARCH = "zamba2-2.7b"
COUNTERS = ("generated", "ticks", "scan_ticks", "dispatches", "prefills",
            "prefill_chunks", "rejected", "prefix_hit_pages",
            "prompt_pages", "kv_bytes_peak")


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


def _configs(fused: bool):
    j_cfg = dataclasses.replace(j_get_config(ARCH).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                                use_fused_kernels=fused)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def weights():
    j_cfg, t_cfg = _configs(False)
    jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                                 device="cpu")


def _j_layers(cache, name, cfg):
    """The reference cache's ``name`` leaves in layer order, stacked: the
    port's layout (pattern groups unstacked, layers without the leaf
    skipped)."""
    period = len(cfg.layer_pattern)
    rows = []
    for i in range(cfg.num_layers):
        d = cache["blocks"][i % period]
        if name in d:
            rows.append(np.asarray(d[name][i // period]))
    return np.stack(rows)


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
def test_prefill_matches_reference(weights, fused):
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    tokens = np.random.default_rng(3).integers(
        0, t_cfg.vocab_size, (2, 37)).astype(np.int32)
    jl, jc = j_prefill(jp, j_cfg, {"tokens": jnp.asarray(tokens)})
    tl, tc = prefill(tp, t_cfg, torch.from_numpy(tokens))
    _rel_close(tl.numpy(), jl)
    assert sorted(tc) == ["conv", "k", "ssm", "v"]
    assert tc["k"].shape[0] == 2 and tc["ssm"].shape[0] == 4
    for name in tc:
        _rel_close(tc[name].numpy(), _j_layers(jc, name, t_cfg))


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
def test_placed_prefill_then_decode_matches_reference(weights, fused):
    """Prompts of 20 and 5 tokens placed into slots 0 and 1 (slot 1
    admitted after three steps, idle before), then 6 decode steps."""
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    slots, max_len, ps = 2, 64, 16
    jk = JPagedKVCache(j_cfg, slots=slots, max_len=max_len, page_size=ps)
    tk = PagedKVCache(t_cfg, slots=slots, max_len=max_len, page_size=ps,
                      device="cpu")
    jcache, tcache = jk.init_cache(), tk.init_cache()
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
        assert np.array_equal(jk.ensure(slot, len(p)), pages)
        jl, fresh = j_prefill(jp, j_cfg, {"tokens": jnp.asarray(p)[None]})
        jcache = jkv.place_prefill(jcache, fresh, jnp.int32(slot),
                                   jnp.asarray(pages),
                                   layout=j_cfg.kv_cache_layout)
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
                for kc in (jk, tk):
                    kc.ensure(s, int(pos[s]) + 1)
        jt, jl, jcache = j_decode_step(jp, j_cfg, tok, jcache, pos, lengths,
                                       page_table=jk.page_table)
        tt, tl, tcache = decode_step(
            tp, t_cfg, torch.from_numpy(tok), tcache, torch.from_numpy(pos),
            torch.from_numpy(lengths), page_table=tk.page_table)
        live = lengths > 0
        _rel_close(tl.numpy()[live], np.asarray(jl)[live])
        np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])
        tok = tt.numpy().copy()
        pos = np.where(live, pos + 1, pos)
        lengths = np.where(live, lengths + 1, 0).astype(np.int32)
    for name in ("ssm", "conv"):          # conv: bf16 in both packages
        _rel_close(tcache[name].float().numpy(),
                   _j_layers(jcache, name, t_cfg).astype(np.float32))
    tk.assert_page_accounting(tcache)


ENGINE_CASES = [("none", True), ("kv_int8", True), ("w8_kv8", True),
                ("none", False)]


@pytest.mark.parametrize("quant,fused", ENGINE_CASES,
                         ids=[f"{q}-{'kernel' if f else 'eager'}"
                              for q, f in ENGINE_CASES])
def test_engine_greedy_tokens_equal_reference(weights, quant, fused):
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, t_cfg.vocab_size, n).astype(np.int32)
               for n in (5, 37, 20)]
    kw = dict(batch_slots=2, max_len=128, quant=quant)
    ref = JServingEngine(j_cfg, jp, **kw)
    want = [r.out_tokens for r in ref.generate([p.copy() for p in prompts],
                                               max_new_tokens=8)]
    eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=8)
    assert [r.out_tokens for r in got] == want
    assert eng.chunked is False and eng.prefix is None
    m, jm = eng.metrics, ref.metrics
    assert {k: m[k] for k in COUNTERS} == {k: int(jm[k]) for k in COUNTERS}
    assert m["generated"] == 24 and m["prefills"] == 3
    assert m["quant"] == quant
    eng.kv.assert_page_accounting(eng.cache)


def test_engine_refuses_chunked_prefill_and_speculation(weights):
    _, tp = weights
    _, t_cfg = _configs(True)
    with pytest.raises(ValueError, match="chunked prefill"):
        ServingEngine(t_cfg, tp, chunked=True, device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        ServingEngine(t_cfg, tp, speculative=True, device="cpu")
    with pytest.raises(ValueError, match="prefix_cache requires"):
        ServingEngine(t_cfg, tp, prefix_cache=True, device="cpu")
