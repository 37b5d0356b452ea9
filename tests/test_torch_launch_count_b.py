"""The op-level cost counter (``launch.op_analysis``) against the
reference's HLO analysis on the CPU: hubert-xlarge, llama3-8b and the Qwen decoders.

Each reduced registry config's prefill, decode and train cell at 2 x 128
tokens: the port's FLOPs within 10% of ``analyze_hlo`` on the
reference's compiled cell (``lower_cell`` on a 1 x 1 host mesh), its
parameter and cache bytes equal to the reference's leaf bytes, and no op
left unpriced (``tests/_torch_launch_ref.py``).
The measured ratios are in PERF.md.
"""

import pytest

from _torch_launch_ref import _one_thread, cases, check_cell  # noqa: F401

ARCHS = ("hubert-xlarge", "llama3-8b", "qwen1.5-0.5b", "qwen2-vl-2b", "qwen3-0.6b")


@pytest.mark.parametrize("arch,kind", cases(ARCHS))
def test_flops_and_bytes_match_reference(arch, kind):
    check_cell(arch, kind)
