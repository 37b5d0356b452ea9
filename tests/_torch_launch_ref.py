"""Shared by the ``test_torch_launch_count_*`` files: one reduced
registry cell at 2 x 128 tokens counted by the port
(``launch.op_analysis.count_cell``) and by the reference
(``lower_cell(...).compile()`` on ``make_host_mesh(1, 1)``, then
``analyze_hlo``), with both packages' parameter and cache bytes."""

import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShape
from repro.distributed.steps import lower_cell
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_host_mesh
from repro.models import abstract_cache as j_abstract_cache
from repro.models import abstract_params as j_abstract_params
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.op_analysis import count_cell, storage_bytes
from repro_torch.models import abstract_cache, abstract_params

BATCH, SEQ = 2, 128
KINDS = ("prefill", "decode", "train")
# The port's FLOPs within this share of the reference's on every cell.
FLOP_REL = 0.10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small CPU ops: one intra-op thread (restored after the
    module), so that test workers beside one another do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cases(archs):
    return [(a, k) for a in archs for k in KINDS
            if not (k == "decode" and get_config(a).encoder_only)]


def _leaf_bytes(tree) -> int:
    return sum(math.prod(a.shape) * np.dtype(a.dtype).itemsize
               for a in jax.tree.leaves(tree))


def check_cell(arch: str, kind: str, perf: bool = False) -> None:
    """One cell; ``perf`` applies both packages' perf-mode config
    replacement (``lower_cell(..., perf=True)``, ``count_cell(...,
    perf=True)``)."""
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    want = analyze_hlo(lower_cell(jcfg, JShape(kind, SEQ, BATCH, kind),
                                  make_host_mesh(1, 1), perf=perf)
                       .compile().as_text())
    count, memory = count_cell(cfg, ShapeConfig(kind, SEQ, BATCH, kind),
                               perf=perf)
    ratio = count.flops / want["flops"]
    # ``pytest -s`` prints each cell's ratio (PERF.md's table).
    print(f"[count] {arch} {kind}{' perf' if perf else ''} port "
          f"{count.flops:.4e} reference {want['flops']:.4e} "
          f"ratio {ratio:.4f}")
    assert abs(ratio - 1) <= FLOP_REL, (arch, kind, ratio)
    assert storage_bytes(abstract_params(cfg)) == \
        _leaf_bytes(j_abstract_params(jcfg))
    if kind == "decode":
        assert storage_bytes(abstract_cache(cfg, BATCH, SEQ)) == \
            _leaf_bytes(j_abstract_cache(jcfg, BATCH, SEQ))
    assert memory["argument_bytes"] > storage_bytes(abstract_params(cfg))
    assert "unpriced_ops" not in memory, memory["unpriced_ops"]
