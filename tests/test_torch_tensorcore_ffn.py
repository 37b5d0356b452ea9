"""The streamed FFN's tensor-core kernel (K4, K6, K10b, K10c in bf16), on
the CPU: its plan (``common.ffn_plan``) and what the wrappers hand its C
entry points (a fake library stands in for the build).

The CUDA code runs only on the card, where ``chip_smoke.py`` holds every
instance against its plain version and its rows bit for bit from 1 to 64
rows; the plain versions are held to the Pallas kernels in
``test_torch_kernels.py`` and ``test_torch_quantized.py``.
"""

import importlib
import types

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.common import (FFN_BF, FFN_BN, FFN_BT,
                                       FFN_FUSED_BF, ROW_INVARIANT_T, cdiv,
                                       ffn_plan, round_up)

ffn_mod = importlib.import_module("repro_torch.kernels.streamed_ffn")
# (D, F, gated) of each path's FFN: llama3-8b (K4, K10b), gpt2's MLP (K6,
# K10c) and zamba2-2.7b's shared block (K4, K10b with GELU).
PATH_DF = {"llama3-8b": (4096, 14336, True), "gpt2": (1024, 4096, False),
           "zamba2-2.7b": (2560, 10240, True)}
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12   # H100 SXM data sheet


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("model", sorted(PATH_DF))
def test_ffn_plan_splits_alike_up_to_64_rows(model, sms):
    """One fused launch whose F split follows from (D, F, SMs) alone, so
    a row's sums are the same at every row count up to 64; about one
    block per SM."""
    d, f, _ = PATH_DF[model]
    first = ffn_plan(1, d, f, sms)
    for t in range(2, ROW_INVARIANT_T + 1):
        assert ffn_plan(t, d, f, sms) == first, t
    mode, f_per_split, splits = first
    assert mode == 0
    assert f_per_split % FFN_FUSED_BF == 0
    assert (splits - 1) * f_per_split < f <= splits * f_per_split
    assert splits <= sms < 2 * splits or splits == cdiv(f, FFN_FUSED_BF)


@pytest.mark.parametrize("t", [128, 1000, 4096])
@pytest.mark.parametrize("model", sorted(PATH_DF))
def test_ffn_plan_above_64_rows_stays_within_the_weight_bytes(model, t):
    """Two passes: the split partials' traffic is within the weight
    bytes of every instance (2 D F, the int8 MLP's, at the least), and h
    [T, F] in bf16 is no larger than the path's weights, or else moves in
    less time than the products take at the bf16 peak (gpt2 at 4096 rows:
    h 34 MB against 17 MB of weights, 0.02 ms of round trip against 0.07
    ms of products)."""
    d, f, gated = PATH_DF[model]
    mode, f_per_split, splits = ffn_plan(t, d, f, 132)
    assert mode == 1
    assert f_per_split % FFN_BF == 0
    assert (splits - 1) * f_per_split < f <= splits * f_per_split
    partials = 2 * splits * t * d * 4 if splits > 1 else 0
    assert partials <= 2 * d * f
    h = t * round_up(f, FFN_BF) * 2
    weights = (3 if gated else 2) * d * f * 2
    products = (6 if gated else 4) * t * d * f
    assert (h <= weights
            or 2 * h / HBM_BYTES_PER_S <= products / BF16_FLOPS)
    if t == 4096 and model != "gpt2":
        assert h <= weights


class _FakeLib:
    """Stands in for the built library: each C entry point records its
    symbol and arguments and returns 0 (cudaSuccess)."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, symbol):
        def entry(*args):
            self.calls.append((symbol, args))
            return 0
        return entry


@pytest.fixture
def card_route(monkeypatch):
    """Force the wrappers' CUDA route for CPU tensors on a 132-SM card."""
    calls = []
    monkeypatch.setattr(ffn_mod, "kernel_path", lambda t: "cuda")
    monkeypatch.setattr(ffn_mod, "sm_count", lambda device: 132)
    monkeypatch.setattr(ffn_mod, "_WORKSPACE", {})
    ffn_mod._entry.cache_clear()
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    yield calls
    ffn_mod._entry.cache_clear()


def _call(kind, t, d, f):
    x = torch.zeros(t, d, dtype=torch.bfloat16)
    s = torch.zeros(d, dtype=torch.bfloat16)
    if kind.endswith("_w8"):
        w, wd = torch.zeros(d, f, dtype=torch.int8), torch.zeros(
            f, d, dtype=torch.int8)
        q8 = dict(wu_scale=torch.ones(f), wd_scale=torch.ones(d))
        if kind == "ffn_w8":
            return K.streamed_ffn_w8(x, w, w, wd, wg_scale=torch.ones(f),
                                     norm_scale=s, **q8)
        return K.streamed_mlp_w8(x, w, wd, **q8)
    w = torch.zeros(d, f, dtype=torch.bfloat16)
    wd = torch.zeros(f, d, dtype=torch.bfloat16)
    if kind == "ffn":
        return K.streamed_ffn(x, w, w, wd, norm_scale=s)
    return K.streamed_mlp(x, w, wd)


@pytest.mark.parametrize("kind", ["ffn", "mlp", "ffn_w8", "mlp_w8"])
@pytest.mark.parametrize("t,d,f", [(4, 1024, 4096), (64, 1024, 4096),
                                   (65, 1024, 4096), (300, 256, 2048),
                                   (4, 1000, 1001), (128, 40, 48)])
def test_bf16_ffn_passes_its_plan(card_route, kind, t, d, f):
    """The entry point gets ``ffn_plan``'s mode and split, partials and
    arrival counters (from the workspace, with room for the split) only
    when it splits, h (two planes for the int8 twins, allocated by the
    wrapper) and, with the folded norm, the normalised rows only in the
    two-pass mode, and the scalar-load flag exactly where a row is not a
    whole number of 16-byte vectors."""
    _call(kind, t, d, f)
    (symbol, args), = card_route
    assert symbol == f"repro_streamed_{kind}_mma_bf16"
    mode, f_per_split, splits = ffn_plan(t, d, f, 132)
    assert args[13:20] == (t, d, f, mode, f_per_split, splits,
                           int(d % 16 == 0 and f % 16 == 0))
    part, ctr, h, xn = args[9:13]
    assert (part is not None) == (ctr is not None) == (splits > 1)
    assert (h is not None) == (mode == 1)
    assert (xn is not None) == (mode == 1 and kind == "ffn_w8"
                                or mode == 1 and kind == "ffn")
    # Only the operands the instance has.
    nscale, wg, gs, wu, us, wd, ds = args[1:8]
    assert (nscale is not None) == kind.startswith("ffn")
    assert (wg is not None) == kind.startswith("ffn")
    assert (us is not None) == (ds is not None) == kind.endswith("_w8")
    assert wu is not None and wd is not None
    if splits > 1:
        part_ws, ctr_ws = ffn_mod._WORKSPACE[torch.device("cpu")]
        assert (part, ctr) == (part_ws.data_ptr(), ctr_ws.data_ptr())
        assert part_ws.numel() >= splits * t * d
        assert ctr_ws.numel() >= cdiv(d, FFN_BN) * cdiv(t, FFN_BT)
        assert not ctr_ws.any()


def test_bf16_ffn_counts_one_launch_per_call(card_route):
    """A call counts once, whichever mode (the two-pass mode launches the
    norm's row pass, UP and DOWN in one call)."""
    before = K.streamed_ffn.launches
    for t in (4, 65, 300):
        _call("ffn", t, 256, 512)
    assert K.streamed_ffn.launches == before + 3
    assert len(card_route) == 3
