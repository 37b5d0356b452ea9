"""The op-level cost counter's conventions and its scaling, on the CPU.

* conventions (``launch/op_analysis.py``, the reference's
  ``hlo_analysis.py:46-63``): a matmul is 2·M·N·K with its operands and
  result as bytes, an elementwise op one flop per output element, a
  reduction one per input element, views and copies free; ``top_items``
  ranks the ops, no collective on one card; ``analyze_step`` has
  ``analyze_hlo``'s keys;
* scaling: every reduced registry config cut to two periods plus a layer
  (every layer kind at least twice, the remainder after a period), its
  train, prefill and decode cells at 2 x 128 tokens, and rwkv6's and
  gemma3's under ``perf`` (``wkv6_chunked``'s chunk loop, per-chunk
  attention remat, the ``bhsd`` cache): the count from the layerless
  stack and one and two layers of each kind, with the recurrences' loops
  from 2, 3 and 4 steps, equals the count of the whole step exactly
  (FLOPs, bytes, priced ops and the memory record's argument, output and
  alias bytes).
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import op_analysis
from repro_torch.launch.op_analysis import count_cell, count_step, top_items


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small CPU ops: one intra-op thread (restored after the
    module), so that test workers beside one another do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def test_conventions():
    m, k, n = 8, 16, 32

    def fn(x, w):
        y = x @ w                        # 2·M·N·K
        z = torch.relu(y).t().contiguous()   # M·N, then free
        return z.sum(dim=0)              # M·N (input elements)

    count, memory = count_step(fn, _meta(m, k), _meta(k, n))
    assert count.flops == 2 * m * n * k + m * n + m * n
    assert count.num_ops == 3
    assert count.bytes == (4 * (m * k + k * n + m * n)      # matmul
                           + 4 * 2 * m * n                  # relu
                           + 4 * (m * n + m))               # sum
    assert memory["argument_bytes"] == 4 * (m * k + k * n)
    assert memory["output_bytes"] == 4 * m and memory["alias_bytes"] == 0
    items = top_items(count, 2, "flops")
    assert items[0][0] == 2 * m * n * k and "mm" in items[0][1]
    assert len(items) == 2 and items[0][0] >= items[1][0]
    assert top_items(count, kind="collective") == []
    with pytest.raises(ValueError):
        top_items(count, kind="latency")


def test_analyze_step_has_analyze_hlo_keys():
    cfg = get_config("llama3-8b").reduced()
    got = op_analysis.analyze_step(cfg, ShapeConfig("p", 32, 1, "prefill"))
    assert set(got) == {"flops", "bytes_accessed", "collective_link_bytes",
                        "collective_operand_bytes", "collective_link_total",
                        "collective_operand_total", "collective_count",
                        "num_ops"}
    assert got["flops"] > 0 and got["collective_count"] == 0
    assert set(got["collective_link_bytes"]) == set(op_analysis.COLLECTIVES)


CASES = [(a, False) for a in sorted(ARCHS)] + [("rwkv6-7b", True),
                                               ("gemma3-4b", True)]


@pytest.mark.parametrize("arch,perf", CASES,
                         ids=[f"{a}{'-perf' if p else ''}" for a, p in CASES])
def test_scaled_count_equals_full_depth(arch, perf):
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, num_layers=2 * len(cfg.layer_pattern) + 1)
    kinds = ("train", "prefill") + (() if cfg.encoder_only else ("decode",))
    for kind in kinds:
        shape = ShapeConfig(kind, 128, 2, kind)
        scaled, mem_s = count_cell(cfg, shape, perf=perf)
        full, mem_f = count_cell(cfg, shape, perf=perf, scale=False)
        assert (scaled.flops, scaled.bytes, scaled.num_ops) == \
            (full.flops, full.bytes, full.num_ops), kind
        for key in ("argument_bytes", "output_bytes", "alias_bytes"):
            assert mem_s[key] == mem_f[key], (kind, key)
