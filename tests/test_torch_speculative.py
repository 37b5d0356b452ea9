"""Speculative verify in the port on the CPU, against the JAX package.

* The plain version of the verify kernel (K8) against the interpret-mode
  Pallas ``paged_verify_attention`` at relative 1e-5, for GQA and MHA
  groupings; each of its rows equal to the decode kernel's plain version
  at that row's length.
* ``paged_append_window`` and ``cow_copy_pool`` bit-equal to JAX's;
  ``rollback_extent`` freeing an exclusive tail and refusing shared pages.
* ``verify_step`` logits against ``repro.models.verify_step`` at relative
  1e-5 on reduced llama3-8b and jittered reduced gpt2, both plans.
* The speculative engine's greedy tokens equal to the JAX speculative
  engine's and to the port's plain engine's, with the speculative and
  prefix counters equal to the JAX engine's.

Everything runs in float32 on weights the JAX ``init_params`` draws,
bridged with ``params_from_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import paged_verify_attention as j_paged_verify
from repro.models import init_params as j_init_params
from repro.models import prefill_chunk as j_prefill_chunk
from repro.models import verify_step as j_verify_step
from repro.serving import PagedKVCache as JPagedKVCache
from repro.serving import ServingEngine as JServingEngine
from repro.serving import kv_cache as jkv
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy, prefill_chunk, verify_step
from repro_torch.serving import NULL_PAGE, PagedKVCache, ServingEngine
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
# Counters the JAX engine's registry and the port's metrics must agree on.
COUNTERS = ("prefix_hit_pages", "prompt_pages", "draft_tokens",
            "accepted_tokens", "spec_tokens", "verify_dispatches",
            "rollbacks", "rollback_pages", "generated")


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _configs(arch: str, fused: bool):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                use_fused_kernels=fused)
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


def _paged_inputs(rng, hq, hkv, *, b=3, d=16, ps=8, n_pages=6, w=5):
    """q [b, w, hq, d], pools, a table with each slot's pages for its
    window, and mixed offsets (one slot idle at offset 0)."""
    q = rng.standard_normal((b, w, hq, d)).astype(np.float32)
    pools = [rng.standard_normal((1 + b * n_pages, ps, hkv, d))
             .astype(np.float32) for _ in range(2)]
    q_off = np.array([5, 33, 0], np.int32)[:b]
    table = np.zeros((b, n_pages), np.int32)
    nxt = 1
    for i in range(b):
        for j in range(-(-(int(q_off[i]) + w) // ps)):
            table[i, j] = nxt
            nxt += 1
    return q, pools[0], pools[1], table, q_off


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("window", [0, 7])
def test_verify_plain_matches_pallas(hq, hkv, window):
    q, kp, vp, table, q_off = _paged_inputs(np.random.default_rng(4), hq,
                                            hkv)
    K.reset_launches()
    got = K.paged_verify_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, table, q_off)),
        window=window)
    assert K.paged_verify_attention.launches == 0      # CPU: plain version
    want = j_paged_verify(*(jnp.asarray(a) for a in (q, kp, vp, table,
                                                     q_off)),
                          window=window, interpret=True)
    _rel_close(got.numpy(), want)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_verify_rows_equal_decode_plain(hq, hkv):
    """Row i of the verify window is the decode kernel at length
    ``q_off + i + 1``: what exact acceptance rests on."""
    q, kp, vp, table, q_off = _paged_inputs(np.random.default_rng(5), hq,
                                            hkv)
    t = {k: torch.from_numpy(a) for k, a in
         dict(q=q, kp=kp, vp=vp, table=table, q_off=q_off).items()}
    out = K.paged_verify_attention(t["q"], t["kp"], t["vp"], t["table"],
                                   t["q_off"])
    for i in range(q.shape[1]):
        row = K.paged_decode_attention(t["q"][:, i:i + 1], t["kp"], t["vp"],
                                       t["table"], t["q_off"] + i + 1)
        assert torch.equal(out[:, i:i + 1], row), i


def test_paged_append_window_and_cow_copy_match_reference():
    rng = np.random.default_rng(6)
    pages, ps, h, d, b, maxp, w = 9, 4, 2, 3, 3, 3, 5
    pool = rng.standard_normal((pages, ps, h, d)).astype(np.float32)
    table = np.array([[3, 5, 0], [7, 1, 2], [4, 6, 8]], np.int32)
    pos = np.array([2, 9, maxp * ps], np.int32)   # straddles; slot 2 past
    new = rng.standard_normal((b, w, h, d)).astype(np.float32)
    want = jkv.paged_append_window(jnp.asarray(pool), table, pos, new,
                                   layout="bshd")
    got = tkv.paged_append_window(torch.from_numpy(pool.copy()),
                                  torch.from_numpy(table),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(new), layout="bshd")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    src = np.array([3, NULL_PAGE, 7], np.int32)
    dst = np.array([8, NULL_PAGE, 6], np.int32)
    np.testing.assert_array_equal(
        tkv.cow_copy_pool(torch.from_numpy(pool.copy()),
                          torch.from_numpy(src),
                          torch.from_numpy(dst)).numpy(),
        np.asarray(jkv.cow_copy_pool(jnp.asarray(pool), src, dst)))
    # Stacked over layers, as the engine copies every pool at once.
    stacked = np.stack([pool, pool + 1.0])
    got2 = tkv.cow_copy_pool(torch.from_numpy(stacked.copy()),
                             torch.from_numpy(src), torch.from_numpy(dst))
    for layer in range(2):
        np.testing.assert_array_equal(
            got2[layer].numpy(),
            np.asarray(jkv.cow_copy_pool(jnp.asarray(stacked[layer]), src,
                                         dst)))


def test_rollback_extent_frees_exclusive_tail():
    cfg = get_config("llama3-8b").reduced()
    kv = PagedKVCache(cfg, slots=2, max_len=64, page_size=16, device="cpu")
    kv.ensure(0, 60)                              # 4 pages
    assert kv.rollback_extent(0, 20) == 2 and kv.pages_in_use == 2
    assert np.count_nonzero(kv.table_row(0) != NULL_PAGE) == 2
    kv.assert_page_accounting()
    assert kv.rollback_extent(0, 32) == 0         # same extent: no-op
    kv.ensure(0, 60)
    assert kv.pages_in_use == 4
    kv.assert_page_accounting()


def test_rollback_extent_refuses_shared_pages():
    cfg = get_config("llama3-8b").reduced()
    kv = PagedKVCache(cfg, slots=2, max_len=64, page_size=16, device="cpu")
    pages = kv.ensure(0, 32)
    kv.adopt_shared(1, int(pages[-1]))            # slot 1 shares the tail
    with pytest.raises(RuntimeError, match="rollback"):
        kv.rollback_extent(0, 1)
    kv.assert_page_accounting()                   # refused: untouched
    kv.release(1)
    kv.mark_tree(int(pages[-1]))                  # the tree owns the tail
    with pytest.raises(RuntimeError, match="rollback"):
        kv.rollback_extent(0, 1)
    kv.assert_page_accounting()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("arch", ARCHS)
def test_verify_step_matches_reference(weights, arch, fused):
    """A 40-token prompt prefilled into slot 0 in one chunk, then a 5-row
    window (pending token + 4 drafts) verified with slot 1 idle."""
    jp, tp = weights[arch]
    j_cfg, t_cfg = _configs(arch, fused)
    slots, max_len, ps, chunk, w = 2, 128, 16, 64, 5
    jkc = JPagedKVCache(j_cfg, slots=slots, max_len=max_len, page_size=ps)
    tkc = PagedKVCache(t_cfg, slots=slots, max_len=max_len, page_size=ps,
                       device="cpu")
    jcache, tcache = jkc.init_cache(), tkc.init_cache()
    rng = np.random.default_rng(7)
    plen = 40
    prompt = rng.integers(0, t_cfg.vocab_size, plen).astype(np.int32)
    for kc in (jkc, tkc):
        kc.ensure(0, chunk)
    row = tkc.table_row(0)
    toks, cpages, last = stage_chunk(prompt, 0, chunk, row, ps)
    jt, _, jcache = j_prefill_chunk(jp, j_cfg, toks[None], jcache, row,
                                    cpages, 0, last)
    tt, _, tcache = prefill_chunk(
        tp, t_cfg, torch.from_numpy(toks)[None], tcache,
        torch.from_numpy(row), torch.from_numpy(cpages), 0, last)
    assert int(tt[0, 0]) == int(np.asarray(jt)[0, 0])
    window = np.zeros((slots, w), np.int32)
    window[0, 0] = int(tt[0, 0])
    window[0, 1:] = rng.integers(0, t_cfg.vocab_size, w - 1)
    pos = np.array([plen, tkc.extent], np.int32)
    lengths = np.array([plen, 0], np.int32)
    for kc in (jkc, tkc):
        kc.ensure(0, plen + w)
    jg, jl, jcache = j_verify_step(jp, j_cfg, window, jcache, pos, lengths,
                                   page_table=jkc.page_table)
    tg, tl, tcache = verify_step(
        tp, t_cfg, torch.from_numpy(window), tcache, torch.from_numpy(pos),
        torch.from_numpy(lengths), page_table=tkc.page_table)
    _rel_close(tl.numpy()[0], np.asarray(jl)[0])
    np.testing.assert_array_equal(tg.numpy()[0], np.asarray(jg)[0])
    pages = tkc.slot_pages(0)
    shape = (t_cfg.num_layers, -1, t_cfg.num_kv_heads, t_cfg.head_dim_)
    for name in ("k", "v"):
        got = tcache[name][:, pages].reshape(shape)[:, :plen + w]
        want = np.asarray(jcache["blocks"][0][name])[:, pages]
        _rel_close(got.numpy(), want.reshape(shape)[:, :plen + w])


def _burst(vocab: int):
    """A shared 160-token prefix (past the 128-token chunk, so the
    fused plan's chunk-aligned matching hits), distinct suffixes, one
    prompt repeated verbatim (tree drafts and the catch-up claim) and one
    periodic prompt (n-gram drafts)."""
    rng = np.random.default_rng(8)
    shared = rng.integers(0, vocab, 160).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)
                               .astype(np.int32)]) for n in (10, 70, 3)]
    prompts.append(prompts[0].copy())
    prompts.append(np.array([1, 2, 3, 4, 5, 6, 7, 8] * 6, np.int32))
    return prompts


@pytest.mark.parametrize("arch", ARCHS)
def test_speculative_engine_matches_reference(weights, arch):
    jp, tp = weights[arch]
    j_cfg, t_cfg = _configs(arch, True)
    prompts = _burst(t_cfg.vocab_size)
    kw = dict(batch_slots=2, max_len=512, speculative=True, draft_len=4)
    ref = JServingEngine(j_cfg, jp, **kw)
    want = [r.out_tokens for r in ref.generate([p.copy() for p in prompts],
                                               max_new_tokens=12)]
    eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
    eng._debug_check_pages = True
    got = eng.generate(prompts, max_new_tokens=12)
    plain = ServingEngine(t_cfg, tp, batch_slots=2, max_len=512,
                          prefix_cache=False, device="cpu")
    assert [r.out_tokens for r in got] == want
    assert [r.out_tokens for r in plain.generate(prompts,
                                                 max_new_tokens=12)] == want
    m, jm = eng.metrics, ref.metrics
    assert {k: m[k] for k in COUNTERS} == {k: int(jm[k]) for k in COUNTERS}
    assert eng.draft_len == ref.draft_len and eng._w_ladder == ref._w_ladder
    assert m["prefix_hit_pages"] > 0 and m["rollbacks"] > 0
    assert m["accepted_tokens"] > 0
    assert m["accept_rate"] == pytest.approx(jm["accept_rate"])
    assert m["dispatches_per_token"] == pytest.approx(
        jm["dispatches_per_token"])
    assert m["prefix_hit_rate"] == pytest.approx(jm["prefix_hit_rate"])
    assert m["pages_in_use"] == 0
    eng.kv.assert_page_accounting(eng.cache)
