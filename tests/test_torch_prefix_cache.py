"""The port's prefix cache on the CPU, against ``repro.serving``.

* One scripted sequence of insert / catch-up claim / release / eviction
  under allocation pressure / claim / COW through the JAX ``PrefixCache``
  and the port's, each over its own allocator: the same pages, hits,
  drafts and allocator state after every step, in both matching modes.
* The engine: on by default whenever prefill is chunked, with the
  reference's ``ValueError``s for the combinations it refuses; greedy
  tokens and prefix counters equal to the JAX engine's on a burst that
  shares a prefix (reduced llama3-8b and jittered reduced gpt2, float32),
  and equal to the port's plain engine; the admission policies' order.
* Bootstrap admission held against the cold engine's tokens (the JAX
  bootstrap has a known fault of its own), with and without speculation.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.serving import PagedKVCache as JPagedKVCache
from repro.serving import PrefixCache as JPrefixCache
from repro.serving import ServingEngine as JServingEngine
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro_torch.configs import get_config
from repro_torch.models import params_from_numpy
from repro_torch.serving import PagedKVCache, PrefixCache, ServingEngine

ARCHS = ("llama3-8b", "gpt2")
COUNTERS = ("prefix_hit_pages", "prompt_pages", "prefill_chunks",
            "prefills", "generated")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU runs here are many small ops: one intra-op thread
    each (restored after the module), so that the test workers running
    beside one another do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch: str, fused: bool = False):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                use_fused_kernels=fused)
    return j_cfg, t_cfg


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        j_cfg, t_cfg = _configs(arch)
        jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
        if arch == "gpt2":
            jp = j_jitter_params(jp)
        out[arch] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                           t_cfg, device="cpu"))
    return out


def _prompt(n: int, seed: int) -> np.ndarray:
    vocab = get_config("llama3-8b").reduced().vocab_size
    return np.random.default_rng(seed).integers(1, vocab, n).astype(np.int32)


class _Pair:
    """The same operation on the JAX and the port prefix caches, with the
    allocator state compared after it."""

    def __init__(self, *, bootstrap: bool, chunk: int):
        kw = dict(slots=2, max_len=32, page_size=4)
        self.jkv = JPagedKVCache(_configs("llama3-8b")[0], **kw)
        self.tkv = PagedKVCache(_configs("llama3-8b")[1], device="cpu", **kw)
        self.jpc = JPrefixCache(self.jkv, chunk=chunk, bootstrap=bootstrap)
        self.tpc = PrefixCache(self.tkv, chunk=chunk, bootstrap=bootstrap)

    def same_state(self):
        j, t = self.jkv, self.tkv
        np.testing.assert_array_equal(t._table, j._table)
        np.testing.assert_array_equal(t._refs, j._refs)
        assert t._free == j._free
        assert t._tree == j._tree
        assert (t.pages_in_use, t.pages_cached) == (j.pages_in_use,
                                                    j.pages_cached)
        assert (self.tpc.nodes, self.tpc.evictions) == (self.jpc.nodes,
                                                        self.jpc.evictions)
        t.assert_page_accounting()

    def kv(self, method, *args):
        got = getattr(self.tkv, method)(*args)
        want = getattr(self.jkv, method)(*args)
        self.same_state()
        return got, want

    def pc(self, method, *args):
        got = getattr(self.tpc, method)(*args)
        want = getattr(self.jpc, method)(*args)
        self.same_state()
        return got, want

    def release(self, slot):
        self.pc("release_slot", slot)
        self.kv("release", slot)


def _same(pair):
    got, want = pair
    if hasattr(want, "__dataclass_fields__"):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_scripted_sequence_matches_reference():
    """Every eviction here picks the LRU leaf of a single chain, which the
    reference decides the same way whatever order it re-stamps a slot's
    nodes in (it iterates a set)."""
    p = _Pair(bootstrap=False, chunk=8)
    pa, pb = _prompt(32, 21), _prompt(32, 22)
    p.kv("ensure", 0, 32)
    _same(p.pc("insert", 0, pa))                   # 8 nodes
    # Slot 1 computed pa's first 4 pages itself, then catches up.
    p.kv("ensure", 1, 16)
    _same(p.pc("extend_claim", 1, pa, 16))
    p.release(0)
    _same(p.pc("suggest", pa[:10], 6))             # tree continuation
    _same(p.pc("lookup_pages", pa))
    p.release(1)
    p.kv("ensure", 0, 32)
    _same(p.pc("insert", 0, pb))                   # the pool is all tree
    p.release(0)
    p.kv("ensure", 1, 32)                          # evicts pa, LRU first
    _same(p.pc("lookup_pages", pa))
    _same(p.pc("claim", 0, pb))                    # 6 pages: chunk grid
    p.kv("ensure", 0, 32)                          # evicts pb's tail
    p.release(1)
    p.release(0)
    _same(p.pc("suggest", pb[:6], 9))
    _same(p.pc("claim", 1, pb[:30]))
    _same(p.pc("evict_lru_leaf"))
    p.release(1)


def test_eviction_prunes_interior_pages_pinned_by_suffix_claims():
    """With no unreferenced leaf (slot 1 adopted a suffix of the chain),
    eviction prunes the LRU unreferenced subtree: the slot's nodes are
    re-stamped root first, so the shallowest goes and frees the most;
    the adopted pages lose tree custody but keep serving slot 1."""
    kv = PagedKVCache(_configs("llama3-8b")[1], slots=2, max_len=32,
                      page_size=4, device="cpu")
    pc = PrefixCache(kv, chunk=4)
    pa = _prompt(32, 21)
    kv.ensure(0, 32)
    pc.insert(0, pa)
    a_pages = list(kv.slot_pages(0))
    kv.ensure(1, 16)
    assert pc.extend_claim(1, pa, 16) == (28, 3)
    pc.release_slot(0)
    kv.release(0)
    assert kv.pages_cached == 5                    # nodes 0..3 and 7
    kv.ensure(0, 32)
    assert kv.pages_in_use == 15                   # 8 + 4 + 3 adopted
    assert kv.pages_cached == 0 and len(kv._free) == 1
    assert pc.nodes == 0 and pc.evictions == 5
    for pg in a_pages[4:7]:
        assert kv.page_refs(pg) == 1
    kv.assert_page_accounting()
    kv.release(1)
    kv.release(0)
    kv.assert_page_accounting()
    assert kv.pages_in_use == 0 and kv.pages_cached == 0


def test_bootstrap_claim_and_cow_match_reference():
    p = _Pair(bootstrap=True, chunk=4)
    pa = _prompt(24, 23)
    p.kv("ensure", 0, 24)
    _same(p.pc("insert", 0, pa))
    p.release(0)
    for prompt in (pa, pa[:19], pa[:9]):           # aligned, mid-page
        got, want = p.pc("claim", 1, prompt)
        _same((got, want))
        if got.cow is not None:
            pages = p.kv("cow_page", 1, got.cow)
            _same(pages)
            _same(p.pc("page_released", int(pages[0][0])))   # the src
        p.release(1)


def test_engine_defaults_to_the_prefix_cache(weights):
    _, tp = weights["llama3-8b"]
    _, t_cfg = _configs("llama3-8b")
    assert ServingEngine(t_cfg, tp, device="cpu").prefix is not None
    assert ServingEngine(t_cfg, tp, chunked=False,
                         device="cpu").prefix is None
    assert ServingEngine(t_cfg, tp, prefix_cache=False,
                         device="cpu").prefix is None
    for kw, match in ((dict(admission="lifo"), "admission policy"),
                      (dict(admission="prefix", prefix_cache=False),
                       "requires prefix_cache"),
                      (dict(chunked=False, prefix_cache=True),
                       "requires chunked"),
                      (dict(prefix_cache=False, prefix_bootstrap=True),
                       "requires prefix_cache"),
                      (dict(speculative=True, draft_len=0), "draft_len")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(t_cfg, tp, device="cpu", **kw)


def _shared_burst(vocab: int):
    """Three prompts over one 80-token prefix (one 64-token chunk is
    claimable), one repeated verbatim, one unrelated."""
    rng = np.random.default_rng(9)
    shared = rng.integers(1, vocab, 80).astype(np.int32)
    out = [np.concatenate([shared, rng.integers(1, vocab, n)
                           .astype(np.int32)]) for n in (7, 50, 2)]
    out.append(out[1].copy())
    out.append(rng.integers(1, vocab, 33).astype(np.int32))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_engine_matches_reference(weights, arch):
    jp, tp = weights[arch]
    j_cfg, t_cfg = _configs(arch)
    prompts = _shared_burst(t_cfg.vocab_size)
    ref = JServingEngine(j_cfg, jp, batch_slots=2, max_len=256)
    want = [r.out_tokens for r in ref.generate([q.copy() for q in prompts],
                                               max_new_tokens=6)]
    eng = ServingEngine(t_cfg, tp, batch_slots=2, max_len=256, device="cpu")
    got = eng.generate(prompts, max_new_tokens=6)
    cold = ServingEngine(t_cfg, tp, batch_slots=2, max_len=256,
                         prefix_cache=False, device="cpu")
    assert [r.out_tokens for r in got] == want
    assert [r.out_tokens for r in cold.generate(prompts,
                                                max_new_tokens=6)] == want
    m, jm = eng.metrics, ref.metrics
    assert {k: m[k] for k in COUNTERS} == {k: int(jm[k]) for k in COUNTERS}
    assert m["prefix_hit_pages"] > 0
    assert m["prefill_chunks"] < cold.metrics["prefill_chunks"]
    assert m["prefix_hit_rate"] == pytest.approx(jm["prefix_hit_rate"])
    assert m["prefix_cached_pages"] == jm["prefix_cached_pages"] > 0
    assert m["pages_in_use"] == 0
    eng.kv.assert_page_accounting(eng.cache)


_COLD = {}


@pytest.mark.parametrize("speculative", [False, True],
                         ids=["decode", "speculative"])
def test_bootstrap_matches_cold_engine(weights, speculative):
    """A fully cached prompt skips prefill and decodes on top of a
    copy-on-written tail page, page-aligned and mid-page; the cached run
    is never mutated, so it replays exactly."""
    _, tp = weights["llama3-8b"]
    _, t_cfg = _configs("llama3-8b")
    plong = np.array(([3, 1, 4, 1, 5, 9, 2, 6] * 8)[:64], np.int32)
    pmid = plong[:57].copy()

    def cold(prompt):
        # A cold engine's tokens, once per prompt for the module.
        key = prompt.tobytes()
        if key not in _COLD:
            e = ServingEngine(t_cfg, tp, batch_slots=1, max_len=128,
                              prefix_cache=False, device="cpu")
            _COLD[key] = e.generate([prompt], max_new_tokens=6)[0].out_tokens
        return _COLD[key]

    boot = ServingEngine(t_cfg, tp, batch_slots=1, max_len=128,
                         prefix_bootstrap=True, speculative=speculative,
                         device="cpu")
    boot._debug_check_pages = True
    boot.generate([plong], max_new_tokens=6)       # cold: fills the tree
    for i, prompt in enumerate((plong, pmid, plong)):
        r = boot.generate([prompt], max_new_tokens=6)[0]
        assert r.out_tokens == cold(prompt), i
        assert r.ttft_s > 0
    assert boot.metrics["prefix_bootstraps"] == 3
    assert boot.metrics["cow_copies"] == 3
    if speculative:
        assert boot.metrics["verify_dispatches"] > 0
    boot.kv.assert_page_accounting(boot.cache)
    assert boot.kv.pages_in_use == 0


def test_admission_policies(weights):
    _, tp = weights["llama3-8b"]
    _, t_cfg = _configs("llama3-8b")
    long_p, short_p = _prompt(100, 12), _prompt(6, 13)
    sjf = ServingEngine(t_cfg, tp, batch_slots=1, max_len=128,
                        admission="sjf", device="cpu")
    reqs = sjf.generate([long_p, short_p], max_new_tokens=3)
    assert all(r.done and not r.failed for r in reqs)
    assert reqs[1].first_token_at < reqs[0].first_token_at
    cached, fresh = _prompt(100, 14), _prompt(100, 15)
    pre = ServingEngine(t_cfg, tp, batch_slots=1, max_len=128,
                        admission="prefix", device="cpu")
    pre.generate([cached], max_new_tokens=2)
    reqs = pre.generate([fresh, cached], max_new_tokens=3)
    assert all(r.done and not r.failed for r in reqs)
    assert reqs[1].first_token_at < reqs[0].first_token_at
    assert pre.metrics["prefix_hit_pages"] > 0
