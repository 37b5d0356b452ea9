"""The port's StreamTensor compiler on the CPU, against the JAX package.

* ``compile_model`` of the five ported families' registry configs
  (llama3-8b, gpt2, both granite-moe configs, zamba2-2.7b, rwkv6-7b) at
  full width and ``reduced()``, at 32, 128 and 1000 tokens, with the
  reference's defaults (TPU_V5E, ``dse_budget`` 12), equals
  ``repro.core.compile_model``: the graph (nodes in order, every
  ``KernelNode`` field, edges with their keys and both itensor types),
  every edge's converter spec, the DSE trial, the fusion groups, the FIFO
  plan, the partition, the allocation, the memory report, the lowered
  implementations (kernel modules mapped ``repro.`` -> ``repro_torch.``)
  and ``summary()``; everything but ``stage_seconds``.
* ``trace_block`` (every layer kind), ``trace_lm_head`` and
  ``block_flops``; ``explore`` with ``seed_trials``; ``size_fifos`` under
  each equalization strategy with exact and closed-form curves;
  ``solve_lp_scipy``; the platform and memory-tier tables.
* ``simulate_dataflow``: LP-sized plans complete on random DAGs and on a
  compiled block, and an undersized plan with a window consumer gives the
  reference's ``SimResult``, deadlocked or not.
* The slice as a whole: every edge of the compiled ``llama3-8b.reduced()``
  and ``gpt2.reduced()`` blocks at 32 tokens streams the same numpy data
  through the reference's interpret-mode Pallas ``convert_layout`` and the
  port's, with equal outputs.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as P
from repro.configs import get_config as j_get_config
from repro.core import fifo_sizing as j_fifo
from repro.core import trace as j_trace
from repro.kernels import convert_layout as j_convert_layout
from repro.runtime import simulate_dataflow as j_simulate
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.core import fifo_sizing as p_fifo
from repro_torch.core import trace as p_trace
from repro_torch.runtime import simulate_dataflow


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = ("llama3-8b", "gpt2", "granite-moe-1b-a400m", "granite-moe-3b-a800m",
         "zamba2-2.7b", "rwkv6-7b", "hubert-xlarge")


def _norm(x, ref=False):
    """The two packages' records as plain values, recursively: a
    dataclass as (class name, fields), a graph as its nodes and keyed
    edges, dicts in insertion order.  On the reference side (``ref``) a
    kernel module ``repro.kernels.X`` reads ``repro_torch.kernels.X``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _norm(getattr(x, f.name), ref))
            for f in dataclasses.fields(x))
    if type(x).__name__ == "DataflowGraph":
        return ("DataflowGraph",
                tuple(_norm(x.kernel(n), ref) for n in x.g.nodes),
                tuple((u, v, k, _norm(d, ref)) for u, v, k, d in x.edges()))
    if isinstance(x, dict):
        return tuple((_norm(k, ref), _norm(v, ref)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v, ref) for v in x)
    if isinstance(x, (set, frozenset)):
        return frozenset(_norm(v, ref) for v in x)
    if ref and isinstance(x, str) and x.startswith("repro.kernels."):
        return "repro_torch.kernels." + x[len("repro.kernels."):]
    return x


def _configs(arch, width):
    mine, want = get_config(arch), j_get_config(arch)
    if width == "reduced":
        mine, want = mine.reduced(), want.reduced()
    assert dataclasses.asdict(mine) == dataclasses.asdict(want)
    return mine, want


def _compile_pair(arch, width, tokens):
    mine, want = _configs(arch, width)
    return P.compile_model(mine, tokens=tokens), \
        J.compile_model(want, tokens=tokens)


def _fields(c):
    """Everything a ``CompiledDataflow`` decided, but the stage clock."""
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)
            if f.name != "stage_seconds"}


# -------------------------------------------------------- compile_model

@pytest.mark.parametrize("tokens", [32, 128, 1000])
@pytest.mark.parametrize("width", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_compile_model_matches_reference(arch, width, tokens):
    mine, want = _compile_pair(arch, width, tokens)
    g, jg = mine.graph, want.graph
    assert list(g.g.nodes) == list(jg.g.nodes)
    assert _norm(g) == _norm(jg)
    edges = list(g.edges())
    assert [(u, v, k) for u, v, k, _ in edges] == \
        [(u, v, k) for u, v, k, _ in jg.edges()]
    for u, v, k, _ in edges:
        assert _norm(g.edge_converter(u, v, k)) == \
            _norm(jg.edge_converter(u, v, k))
    for name, value in _fields(mine).items():
        assert _norm(value) == _norm(getattr(want, name), ref=True), name
    assert [set(grp) for grp in mine.fusion.groups] == \
        [set(grp) for grp in want.fusion.groups]
    assert [lg.implementation for lg in mine.lowered] == \
        [lg.implementation for lg in want.lowered]
    for lg in mine.lowered:
        assert lg.pallas_module is None or \
            lg.pallas_module.startswith("repro_torch.kernels.")
    assert mine.summary() == want.summary()
    assert "stage_seconds" not in mine.summary()
    assert set(mine.stage_seconds) == set(want.stage_seconds)


@pytest.mark.parametrize("arch", ARCHS)
def test_trace_matches_reference(arch):
    for width in ("full", "reduced"):
        mine, want = _configs(arch, width)
        for layer in range(min(mine.num_layers, 8)):
            for tokens, kv in ((1, 2048), (37, None), (128, None)):
                assert _norm(p_trace.trace_block(
                    mine, tokens=tokens, kv_len=kv, layer_index=layer)) == \
                    _norm(j_trace.trace_block(
                        want, tokens=tokens, kv_len=kv, layer_index=layer))
        for tokens in (1, 128):
            assert _norm(p_trace.trace_lm_head(mine, tokens)) == \
                _norm(j_trace.trace_lm_head(want, tokens))
            assert p_trace.block_flops(mine, tokens, 2048) == \
                j_trace.block_flops(want, tokens, 2048)


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-2.7b"])
def test_explore_with_seed_trials_matches_reference(arch):
    mine, want = _configs(arch, "reduced")
    ops = p_trace.trace_block(mine, tokens=64)
    j_ops = j_trace.trace_block(want, tokens=64)
    for seed in (0, 3):
        kw = dict(budget=8, seed=seed, seed_trials=[(64, 32), (16, 256)])
        got = P.explore(ops, P.TPU_V5E, **kw)
        exp = J.explore(j_ops, J.TPU_V5E, **kw)
        assert got.seed_trials == exp.seed_trials == ((64, 32), (16, 256))
        assert _norm(got.trials) == _norm(exp.trials)
        assert _norm(got.best) == _norm(exp.best)
    # A given trial, keeping its artifacts, as compile_model's fixed path.
    assert _norm(P.evaluate_trial(ops, P.U55C, 32, 64, keep_artifacts=True,
                                  strategy="conservative")) == \
        _norm(J.evaluate_trial(j_ops, J.U55C, 32, 64, keep_artifacts=True,
                               strategy="conservative"))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("strategy", ["normal", "conservative"])
def test_size_fifos_matches_reference(strategy, exact):
    for arch in ("llama3-8b", "rwkv6-7b"):
        mine, want = _compile_pair(arch, "reduced", 32)
        g, jg = mine.graph, want.graph
        timings = {k.name: k.timing for k in g.kernels()}
        j_timings = {k.name: k.timing for k in jg.kernels()}
        got = P.size_fifos(g, timings, strategy=strategy,
                           use_exact_curves=exact)
        exp = J.size_fifos(jg, j_timings, strategy=strategy,
                           use_exact_curves=exact)
        assert _norm(got) == _norm(exp)
        assert p_fifo.verify_plan_against_paper_lp(g, timings, got)
    with pytest.raises(ValueError, match="unknown equalization"):
        P.size_fifos(g, timings, strategy="greedy")


def test_solve_lp_scipy_matches_reference():
    mine, want = _compile_pair("gpt2", "reduced", 32)
    timings = {k.name: k.timing for k in mine.graph.kernels()}
    j_timings = {k.name: k.timing for k in want.graph.kernels()}
    got = p_fifo.solve_lp_scipy(mine.graph, timings)
    assert got is not None
    assert got == j_fifo.solve_lp_scipy(want.graph, j_timings)
    s_dp = P.solve_start_times(mine.graph, timings)
    obj = lambda s: sum(s[v] - s[u] for u, v, _, _ in mine.graph.edges())
    assert obj(s_dp) <= obj(got) + 1e-6


def test_platform_and_tier_tables_match_reference():
    from repro.core import allocation as j_alloc
    from repro.core import platforms as j_platforms
    from repro_torch.core import allocation as p_alloc
    from repro_torch.core import platforms as p_platforms
    # The reference's four platforms verbatim; the port adds its H100.
    mine = dict(p_platforms.PLATFORMS)
    assert mine.pop("h100") is p_platforms.H100
    assert _norm(mine) == _norm(j_platforms.PLATFORMS)
    assert _norm(p_alloc.TPU_TIERS) == _norm(j_alloc.TPU_TIERS)
    assert _norm(p_alloc.U55C_TIERS) == _norm(j_alloc.U55C_TIERS)
    assert set(P.__all__) == set(J.__all__) | {"EAGER", "STAGES", "H100"}


# ---------------------------------------------------------- simulator

def _random_dag(core, seed, n):
    """The reference test's random DAG (``tests/test_fifo_sizing.py``),
    built with either package's classes."""
    rng = random.Random(seed)
    g = core.DataflowGraph()
    it = core.row_major((16, 16), (1, 16))
    for i in range(n):
        g.add_kernel(core.KernelNode(
            name=f"k{i}", op="x", out_type=it,
            timing=core.KernelTiming.from_tokens(
                rng.randint(0, 10), rng.randint(1, 4), 16)))
    for j in range(1, n):
        for i in range(j):
            if rng.random() < 0.4:
                g.connect(f"k{i}", f"k{j}", dst_type=it)
    for j in range(1, n):
        if not g.predecessors(f"k{j}"):
            g.connect(f"k{j-1}", f"k{j}", dst_type=it)
    return g


def _timings(g):
    return {k.name: k.timing for k in g.kernels()}


def test_lp_sized_fifos_complete_in_simulation():
    for seed in range(4):
        g, jg = _random_dag(P, seed, 6), _random_dag(J, seed, 6)
        plan = P.size_fifos(g, _timings(g))
        got = simulate_dataflow(g, _timings(g), plan)
        assert got.completed, f"deadlock with seed {seed}"
        exp = j_simulate(jg, _timings(jg), J.size_fifos(jg, _timings(jg)))
        assert _norm(got) == _norm(exp)
    mine, want = _compile_pair("llama3-8b", "reduced", 32)
    got = simulate_dataflow(mine.graph, _timings(mine.graph), plan=mine.fifo)
    assert got.completed
    assert _norm(got) == _norm(j_simulate(want.graph, _timings(want.graph),
                                          plan=want.fifo))


def _window_chain(core, t, window_tiles):
    """k0 -> conv -> k2 streaming a [t, 16] tensor one row at a time; the
    converter needs ``window_tiles`` tokens before its first firing."""
    g = core.DataflowGraph()
    it = core.row_major((t, 16), (1, 16))
    for name, d in (("k0", 2.0), ("conv", 1.0), ("k2", 1.0)):
        g.add_kernel(core.KernelNode(
            name=name, op="x", out_type=it,
            timing=core.KernelTiming.from_tokens(d, 1.0, t)))
    g.connect("k0", "conv", dst_type=it)
    g.connect("conv", "k2", dst_type=it)
    return g, {"conv": window_tiles}


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_window_consumer_matches_reference(depth):
    """An undersized FIFO in front of a window consumer deadlocks; a deep
    enough one completes; both exactly as in the reference."""
    for t, window in ((8, 4), (12, 6)):
        g, win = _window_chain(P, t, window)
        jg, j_win = _window_chain(J, t, window)
        depths = {e[:3]: depth for e in g.edges()}
        got = simulate_dataflow(g, _timings(g), depths=depths,
                                consume_window=win)
        exp = j_simulate(jg, _timings(jg), depths=depths,
                         consume_window=j_win)
        assert _norm(got) == _norm(exp)
        assert got.completed == (depth >= window)
        if not got.completed:
            assert "conv" in got.deadlock_kernels


# ------------------------------------------------ the slice as a whole

@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2"])
def test_compiled_block_streams_like_the_reference(arch):
    """Every edge of the compiled reduced block at 32 tokens, with and
    without a converter, through both packages' ``convert_layout``."""
    mine, want = _compile_pair(arch, "reduced", 32)
    rng = np.random.default_rng(7)
    j_edges = list(want.graph.edges())
    converters = 0
    for (u, v, k, d), (_, _, _, jd) in zip(mine.graph.edges(), j_edges):
        src, dst = d["src_type"], d["dst_type"]
        x = rng.standard_normal(src.data_shape).astype(np.float32)
        got = K.convert_layout(torch.from_numpy(x), src, dst).numpy()
        exp = np.asarray(j_convert_layout(jnp.asarray(x), jd["src_type"],
                                          jd["dst_type"], interpret=True))
        np.testing.assert_array_equal(got, exp, err_msg=f"{u}->{v}")
        converters += mine.graph.edge_converter(u, v, k) is not None
    assert 0 < converters < len(j_edges)
    assert K.convert_layout.launches == 0
