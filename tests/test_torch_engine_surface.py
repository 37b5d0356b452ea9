"""The rest of the port's engine surface on the CPU, against
``repro.serving.ServingEngine``, and the serving launcher.

On llama3-8b.reduced() in float32 with the same bridged weights:

* ``page_size=`` 4 and 32 with ``prefill_chunk=`` 8 and 48: greedy tokens
  and counters equal the reference engine's at the same arguments, and so
  do the resolved page size and chunk (the chunk rounded up to whole
  pages and clamped to the table extent);
* ``adaptive_decode_block``: ``_decode_block_size`` equals the
  reference's over a grid of (active slots, ``decode_eff``), and an
  adaptive engine's tokens equal the static engine's while its blocks,
  dispatches and ``decode_block_last`` equal the reference's;
* request latencies: ``latency_s``, ``queue_wait_s``, ``ttft_s`` and
  ``tpot_s`` are ``nan`` where the reference's are (a request rejected at
  admission has a finite latency and no first token) and finite and
  ordered elsewhere;
* ``python -m repro_torch.launch.serve``: ``main`` returns 0 with the
  default flags, ``--contiguous`` and ``--page-size 8`` (``--device cpu
  --smoke``), prints the reference's two ``[serve]`` lines, refuses an
  encoder-only arch, and without a card and without ``--device`` raises.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init_params
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import params_from_numpy
from repro_torch.serving import ServingEngine

ARCH = "llama3-8b"
BURST = (40, 5, 75, 21, 9)
NEW = 6
KW = dict(batch_slots=3, max_len=96)
COUNTERS = ("generated", "prefills", "prefill_chunks", "dispatches",
            "ticks", "scan_ticks", "prefix_hit_pages", "prompt_pages")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small CPU ops: one intra-op thread (restored after the
    module), so that test workers beside one another do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(fused=True):
    kw = dict(dtype="float32", use_fused_kernels=fused)
    return (dataclasses.replace(j_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@pytest.fixture(scope="module")
def weights():
    j_cfg, t_cfg = _configs()
    jp = j_init_params(jax.random.PRNGKey(6), j_cfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), t_cfg,
                                 device="cpu")


def _burst(vocab):
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in BURST]
    return prompts + [prompts[2].copy()]               # a prefix hit


@pytest.mark.parametrize("page_size,chunk", [(4, 8), (4, 48), (32, 8),
                                             (32, 48)])
def test_page_size_and_prefill_chunk_equal_reference(weights, page_size,
                                                     chunk):
    jp, tp = weights
    j_cfg, t_cfg = _configs()
    prompts = _burst(t_cfg.vocab_size)
    kw = dict(KW, page_size=page_size, prefill_chunk=chunk)
    ref = JServingEngine(j_cfg, jp, verify="off", **kw)
    want = ref.generate(prompts, max_new_tokens=NEW)
    eng = ServingEngine(t_cfg, tp, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=NEW)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert eng.kv.page_size == ref.kv.page_size == page_size
    assert eng.chunk == ref.chunk
    assert eng.chunk % page_size == 0 and eng.chunk >= chunk
    for name in COUNTERS + ("page_size", "prefill_chunk",
                            "kv_bytes_reserved", "kv_bytes_peak"):
        assert eng.metrics[name] == ref.metrics[name], name
    eng.kv.assert_page_accounting(eng.cache)


def test_adaptive_block_size_equals_reference(weights):
    jp, tp = weights
    j_cfg, t_cfg = _configs()
    ref = JServingEngine(j_cfg, jp, verify="off", decode_block=4,
                         adaptive_decode_block=True, **KW)
    eng = ServingEngine(t_cfg, tp, device="cpu", decode_block=4,
                        adaptive_decode_block=True, **KW)
    sizes = set()
    for n_active in range(5):
        for eff in (0.0, 0.3, 0.5, 0.51, 0.74, 1.0):
            ref.decode_eff = eng.decode_eff = eff
            got = eng._decode_block_size(n_active)
            assert got == ref._decode_block_size(n_active), (n_active, eff)
            sizes.add(got)
    assert sizes == {4, 8, 16}
    static = ServingEngine(t_cfg, tp, device="cpu", decode_block=4, **KW)
    static.decode_eff = 0.5
    assert static._decode_block_size(4) == 4


def test_adaptive_tokens_equal_static_engine(weights):
    jp, tp = weights
    j_cfg, t_cfg = _configs()
    prompts = _burst(t_cfg.vocab_size)
    kw = dict(KW, decode_block=2)
    static = ServingEngine(t_cfg, tp, device="cpu", **kw).generate(
        prompts, max_new_tokens=10)
    ref = JServingEngine(j_cfg, jp, verify="off",
                         adaptive_decode_block=True, **kw)
    ref.generate(prompts, max_new_tokens=10)
    eng = ServingEngine(t_cfg, tp, device="cpu",
                        adaptive_decode_block=True, **kw)
    got = eng.generate(prompts, max_new_tokens=10)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in static]
    for name in COUNTERS + ("decode_block_last",):
        assert eng.metrics[name] == ref.metrics[name], name
    assert eng.metrics["scan_ticks"] > 2 * eng.metrics["dispatches"]


def _nan_pattern(r):
    return tuple(math.isnan(getattr(r, a)) for a in
                 ("ttft_s", "latency_s", "queue_wait_s", "tpot_s"))


def test_request_latencies_follow_reference_nan_rules(weights):
    jp, tp = weights
    j_cfg, t_cfg = _configs(fused=False)
    ok = np.arange(1, 12, dtype=np.int32)
    prompts = [np.zeros(0, np.int32), ok, np.ones(97, np.int32), ok[:3]]
    want = JServingEngine(j_cfg, jp, **KW).generate(prompts,
                                                    max_new_tokens=1)
    eng = ServingEngine(t_cfg, tp, device="cpu", **KW)
    got = eng.generate(prompts, max_new_tokens=1)
    assert [_nan_pattern(r) for r in got] == [_nan_pattern(r) for r in want]
    for r in (got[0], got[2]):                      # rejected at admission
        assert r.failed and math.isfinite(r.latency_s)
        assert math.isnan(r.ttft_s) and math.isnan(r.queue_wait_s)
    longer = eng.generate([ok, ok[:5]], max_new_tokens=4)
    for r in longer:
        assert not any(_nan_pattern(r))
        assert 0.0 <= r.queue_wait_s <= r.ttft_s <= r.latency_s


@pytest.mark.parametrize("flags,cache", [([], "paged"),
                                         (["--contiguous"], "contiguous"),
                                         (["--page-size", "8"], "paged")],
                         ids=["default", "contiguous", "page-size-8"])
def test_serve_launcher_returns_zero(flags, cache, capsys):
    assert serve_main(["--arch", ARCH, "--smoke", "--device", "cpu"]
                      + flags) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve]")]
    assert len(lines) == 2
    assert lines[0].startswith("[serve] 8 requests, 128 tokens in ")
    assert lines[1].startswith(f"[serve] kv cache: {cache}, peak ")


def test_serve_launcher_refuses_encoders_and_a_missing_card():
    with pytest.raises(SystemExit):
        serve_main(["--arch", "hubert-xlarge", "--smoke", "--device",
                    "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_main(["--arch", ARCH, "--smoke"])
