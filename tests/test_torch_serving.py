"""The port's paged serving stack on the CPU, against ``repro.serving``.

The engine test runs the reference engine and the port's on the same
weights and the same mixed burst (6 prompts of 5..200 tokens, 4 slots,
max_len 256, 8 new tokens, chunked prefill, no prefix cache) and requires
equal greedy tokens, with the kernel plan and with the eager plan.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.serving import ServingEngine as JServingEngine
from repro.serving import kv_cache as jkv
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.serving import NULL_PAGE, PagedKVCache, ServingEngine
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


BURST = (5, 200, 37, 130, 64, 17)


def _cfgs(fused: bool):
    j_cfg = dataclasses.replace(j_get_config("llama3-8b").reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                                dtype="float32", use_fused_kernels=fused)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def weights():
    j_cfg, t_cfg = _cfgs(False)
    jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                                 device="cpu")


def _burst(vocab: int):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in BURST]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_engine_greedy_tokens_equal_reference(weights, fused):
    jp, tp = weights
    j_cfg, t_cfg = _cfgs(fused)
    prompts = _burst(t_cfg.vocab_size)
    ref = JServingEngine(j_cfg, jp, batch_slots=4, max_len=256, chunked=True,
                         prefix_cache=False).generate(prompts,
                                                      max_new_tokens=8)
    eng = ServingEngine(t_cfg, tp, batch_slots=4, max_len=256, device="cpu")
    got = eng.generate(prompts, max_new_tokens=8)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in ref]
    assert eng.chunk == (128 if fused else 64)
    m = eng.metrics
    assert m["generated"] == 8 * len(BURST)
    assert m["prefills"] == len(BURST)
    assert m["prefill_chunks"] == sum(-(-n // eng.chunk) for n in BURST)
    assert m["ticks"] <= m["scan_ticks"]
    assert m["kv_bytes_peak"] > 0 and m["pages_in_use"] == 0
    for r in got:
        assert r.done and not r.failed
        assert r.ttft_s > 0 and r.tpot_s > 0
    eng.kv.assert_page_accounting(eng.cache)


def test_engine_fails_bad_prompts_at_admission(weights):
    _, tp = weights
    _, t_cfg = _cfgs(False)
    eng = ServingEngine(t_cfg, tp, batch_slots=2, max_len=64, device="cpu")
    ok = np.arange(1, 10, dtype=np.int32)
    reqs = eng.generate([np.zeros(0, np.int32), ok,
                         np.ones(65, np.int32)], max_new_tokens=3)
    assert [r.failed for r in reqs] == [True, False, True]
    assert reqs[0].error == "empty prompt"
    assert "exceeds max_len" in reqs[2].error
    assert len(reqs[1].out_tokens) == 3
    assert eng.metrics["rejected"] == 2
    eng.kv.assert_page_accounting()


def test_allocator_accounting():
    cfg = get_config("llama3-8b").reduced()
    kv = PagedKVCache(cfg, slots=2, max_len=40, page_size=16, device="cpu")
    assert kv.pages_per_slot == 3 and kv.num_pages == 7 and kv.extent == 48
    assert kv.page_bytes == (2 * cfg.num_layers * 16 * cfg.num_kv_heads
                             * cfg.head_dim_ * 2)            # bf16 K and V
    pages = kv.ensure(0, 17)
    assert len(pages) == 2 and NULL_PAGE not in pages
    assert list(kv.table_row(0)) == list(pages) + [NULL_PAGE]
    kv.ensure(1, 40)
    assert kv.pages_in_use == 5 and kv.peak_bytes_in_use == 5 * kv.page_bytes
    kv.assert_page_accounting(kv.init_cache())
    with pytest.raises(ValueError, match="max_len"):
        kv.ensure(0, 41)
    kv.ensure(0, 40)
    with pytest.raises(RuntimeError, match="exhausted"):
        kv.alloc_page()
    kv.release(0)
    kv.release(0)                                 # idempotent
    assert kv.pages_in_use == 3 and not kv.table_row(0).any()
    kv.assert_page_accounting()
    kv.release(1)
    assert kv.pages_in_use == 0 and kv.peak_pages == 6
    kv.assert_page_accounting()


def test_page_primitives_match_reference():
    rng = np.random.default_rng(5)
    pages, ps, h, d, b, maxp = 9, 4, 2, 3, 2, 4
    pool = rng.standard_normal((pages, ps, h, d)).astype(np.float32)
    table = np.array([[3, 5, 0, 0], [7, 1, 2, 0]], np.int32)
    pos = np.array([6, maxp * ps], np.int32)            # slot 1 past extent
    new = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    want = jkv.paged_append(jax.numpy.asarray(pool), table, pos, new,
                            layout="bshd")
    got = tkv.paged_append(torch.from_numpy(pool.copy()),
                           torch.from_numpy(table), torch.from_numpy(pos),
                           torch.from_numpy(new), layout="bshd")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lens = np.array([5, 9], np.int32)
    np.testing.assert_array_equal(
        tkv.live_page_table(torch.from_numpy(table), torch.from_numpy(lens),
                            ps).numpy(),
        np.asarray(jkv.live_page_table(table, lens, ps)))
    np.testing.assert_array_equal(
        tkv.gather_pages(got, torch.from_numpy(table), layout="bshd").numpy(),
        np.asarray(jkv.gather_pages(want, table, layout="bshd")))
    seq = rng.standard_normal((1, 8, h, d)).astype(np.float32)
    cp = np.array([4, 6], np.int32)
    np.testing.assert_array_equal(
        tkv.place_chunk_pages(torch.from_numpy(pool.copy()),
                              torch.from_numpy(seq), torch.from_numpy(cp),
                              layout="bshd").numpy(),
        np.asarray(jkv.place_chunk_pages(jax.numpy.asarray(pool), seq, cp,
                                         layout="bshd")))


@pytest.mark.parametrize("off,plen", [(0, 5), (0, 128), (128, 150),
                                      (64, 300), (256, 300)])
def test_stage_chunk_matches_reference(off, plen):
    prompt = np.arange(1, plen + 1, dtype=np.int32)
    row = np.array([4, 9, 2, 7, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                   np.int32)
    for a, b in zip(tkv.stage_chunk(prompt, off, 128, row, 16),
                    jkv.stage_chunk(prompt, off, 128, row, 16)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
