"""K12 (``moe_experts``) with its routing pass, on the CPU.

Its CUDA code runs only on the card (``chip_smoke.py``'s ``tensorcore``
phase holds it there against the plain version row by row, its rows bit
for bit at 1..64 rows, every call without a host sync; ``chip_phases.py
moe`` hashes its float32 outputs against another tree's).  Here: the
plan that keeps a (token, expert) pair's bits independent of the row
count up to 64 rows, the route each dtype takes to its C entry point with
its workspaces and arguments (a fake library stands in for the build), the
profile's attribution of the new ``__global__`` functions, the plain
version against the interpret-mode Pallas kernel at the new kernels' tile
edges and at adversarial routings on numpy-seeded float32 inputs
(relative 1e-5: the two sum in different orders), a float32 model of the
kernel's kept-pairs-only sum against the dense plain version on the same
routings, and the card check's routings and row-wise error measure.
"""

import importlib
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.moe_experts import moe_experts_pallas
from repro_torch import kernels as K
from repro_torch.kernels import _build, ref
from repro_torch.kernels.common import (MOE_BF, ROW_INVARIANT_T, cdiv,
                                       moe_plan, round_up)

from test_torch_tensorcore import (_FakeLib, _global_functions,
                                   _own_kernels)

moe_mod = importlib.import_module("repro_torch.kernels.moe_experts")
BF16, F32 = torch.bfloat16, torch.float32
REL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
# (D, F, E): granite-3b, granite-1b, the reduced granite configs' shape
# class, an unaligned shape, a wide-F shape with few experts.
WIDTHS = [(1536, 512, 40), (1024, 512, 32), (64, 40, 4), (1000, 1001, 7),
          (4096, 14336, 8)]


@pytest.mark.parametrize("d,f,e", WIDTHS)
def test_moe_plan_depends_on_the_widths_alone_up_to_64_rows(d, f, e):
    """The same fused launch and F split at every row count 1..64 (a
    verify row then runs its decode row's products and sums): 128-column F
    ranges covering F, whatever the experts or the card; two passes (one
    split) above 64 rows."""
    first = moe_plan(1, f)
    for t in range(2, ROW_INVARIANT_T + 1):
        assert moe_plan(t, f) == first, t
    assert first == (0, MOE_BF, cdiv(f, MOE_BF))
    for t in (65, 128, 1000, 4096):
        assert moe_plan(t, f) == (1, f, 1)


@pytest.fixture
def card_route(monkeypatch):
    """Force the CUDA route for CPU tensors, with every library a
    ``_FakeLib``; returns (recorded launches, recorded allocations)."""
    calls, allocs = [], []
    monkeypatch.setattr(moe_mod, "kernel_path", lambda t: "cuda")
    moe_mod._entry.cache_clear()
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(name, calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty

    def record(*shape, **kw):
        out = empty(*shape, **kw)
        allocs.append((tuple(out.shape), out.dtype, out.data_ptr()))
        return out

    monkeypatch.setattr(moe_mod.torch, "empty", record)
    yield calls, allocs
    moe_mod._entry.cache_clear()


def _call(t, d, f, e, dtype):
    x = torch.zeros(t, d, dtype=dtype)
    g = torch.zeros(t, e, dtype=dtype)
    w = torch.zeros(e, d, f, dtype=dtype)
    return K.moe_experts(x, g, w, w.clone(), torch.zeros(e, f, d,
                                                        dtype=dtype))


def _check_workspace(allocs, args, t, d, f, e, dtype, mode, splits):
    """The call allocates its output and one uint8 workspace; each part of
    ``workspace_layout`` is 256-byte aligned, holds its shape, overlaps no
    other, and reaches the entry point as its pointer (None where the
    layout has no such part)."""
    (oshape, odt, _), (wshape, wdt, base) = allocs
    assert (oshape, odt) == ((t, d), dtype)
    nbytes, layout = moe_mod.workspace_layout(t, d, f, e, dtype, mode,
                                              splits)
    assert (wshape, wdt) == ((nbytes,), torch.uint8)
    spans = []
    for name, pos in (("idx", 5), ("counts", 6), ("h", 7), ("part", 8)):
        if name not in layout:
            assert args[pos] is None, name
            continue
        off, shape, dt = layout[name]
        assert off % 256 == 0 and args[pos] == base + off
        spans.append((off, off + dt.itemsize * int(np.prod(shape))))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= nbytes
    return layout


@pytest.mark.parametrize("t,d,f,e", [(1, 1536, 512, 40), (4, 1536, 512, 40),
                                     (16, 1024, 512, 32), (20, 1536, 512, 40),
                                     (64, 1536, 512, 40), (65, 1536, 512, 40),
                                     (128, 1536, 512, 40),
                                     (1000, 1536, 512, 40),
                                     (4096, 1024, 512, 32),
                                     (4, 1000, 1001, 7)])
def test_bf16_moe_passes_its_plan_and_workspaces(card_route, t, d, f, e):
    """The tensor-core entry point gets ``moe_plan``'s mode and split, the
    scalar-load flag exactly where a row is not a whole number of 16-byte
    vectors, and its workspace: float32 partials [splits, E, T, D] and, for
    the two passes alone, the route's idx [E, T] and counts [E] (int32)
    and h [E, T, F rounded up to 64] (the fused launch lists each expert's
    tokens itself)."""
    calls, allocs = card_route
    before = K.moe_experts.launches
    _call(t, d, f, e, BF16)
    (lib, symbol, args), = calls
    assert (lib, symbol) == ("moe_experts", "repro_moe_experts_bf16")
    mode, per, splits = moe_plan(t, f)
    aligned = d % 16 == 0 and f % 16 == 0
    assert args[10:18] == (t, d, f, e, mode, per, splits, int(aligned))
    layout = _check_workspace(allocs, args, t, d, f, e, BF16, mode, splits)
    want = {"part": ((splits, e, t, d), F32)}
    if mode == 1:
        want.update(idx=((e, t), torch.int32), counts=((e,), torch.int32),
                    h=((e, t, round_up(f, 64)), BF16))
    assert {k: v[1:] for k, v in layout.items()} == want
    assert K.moe_experts.launches == before + 1


@pytest.mark.parametrize("t", [4, 100])
def test_f32_moe_reaches_its_entry_point(card_route, t):
    """float32: the CUDA-core entry point with idx, counts, h [E, T, F]
    and partials [E, T, D]."""
    calls, allocs = card_route
    d, f, e = 64, 40, 4
    before = K.moe_experts.launches
    _call(t, d, f, e, F32)
    (lib, symbol, args), = calls
    assert (lib, symbol) == ("moe_experts", "repro_moe_experts_f32")
    assert args[10:14] == (t, d, f, e)
    layout = _check_workspace(allocs, args, t, d, f, e, F32, 1, 1)
    assert {k: v[1:] for k, v in layout.items()} == {
        "idx": ((e, t), torch.int32), "counts": ((e,), torch.int32),
        "h": ((e, t, f), F32), "part": ((e, t, d), F32)}
    assert K.moe_experts.launches == before + 1


def test_moe_refuses_gelu_and_mixed_dtypes_on_the_card(card_route):
    calls, _ = card_route
    x = torch.zeros(4, 64, dtype=BF16)
    g = torch.zeros(4, 4, dtype=BF16)
    w = torch.zeros(4, 64, 40, dtype=BF16)
    wd = torch.zeros(4, 40, 64, dtype=BF16)
    with pytest.raises(ValueError, match="SiLU"):
        K.moe_experts(x, g, w, w, wd, activation="gelu")
    with pytest.raises(TypeError):
        K.moe_experts(x, g.float(), w, w, wd)
    assert calls == []


NEW_KERNELS = {"moe_route_kernel", "moe_mma_kernel", "moe_combine_kernel",
               "moe_h_kernel", "moe_out_kernel"}


def test_profile_attributes_the_new_kernels():
    names = _global_functions()
    assert NEW_KERNELS | {"ffn_mma_kernel"} <= names
    stage = dict(_own_kernels())
    for name in NEW_KERNELS:
        hits = [k for k in stage if k in name]
        assert len(hits) == 1, (name, hits)
        assert stage[hits[0]] == "MoE experts (K12)"
    assert "K12" not in stage["split_reduce_kernel"]


# The tile edges: the fused launch's 16- and 64-row classes and the two
# passes' 64-row tiles; 8 experts, top-2, D and F off the 16-element grid.
EDGE_T = (1, 16, 17, 64, 65, 128)
EDGE_D, EDGE_F, EDGE_E, EDGE_K = 72, 40, 8, 2
ROUTINGS = ("router", "no token keeps expert 0", "all on experts 0..k-1",
            "ties keep 2k", "tiny kept gates")


def _gates(logits, top_k):
    """The router's renormalised top-k gates (ties at the threshold kept),
    in numpy float32."""
    z = logits - logits.max(-1, keepdims=True)
    p = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    thresh = np.sort(p, axis=-1)[:, -top_k][:, None]
    g = np.where(p >= thresh, p, 0.0)
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


def _routing(rng, t, name):
    """x [T, D], gates [T, E] of routing ``name`` (numpy float32)."""
    d, e, k = EDGE_D, EDGE_E, EDGE_K
    x = rng.standard_normal((t, d)).astype(np.float32)
    logits = x @ (rng.standard_normal((d, e)) / d ** 0.5)
    g = _gates(logits, k)
    if name == "no token keeps expert 0":
        g[:, 0] = 0
    elif name == "all on experts 0..k-1":
        g = np.zeros_like(g)
        g[:, :k] = 1.0 / k
    elif name == "ties keep 2k":
        logits[:, :2 * k] = logits.max(-1, keepdims=True) + 1.0
        g = _gates(logits, k)
        assert ((g != 0).sum(-1) >= 2 * k).all()
    elif name == "tiny kept gates":
        rows = np.arange(t)
        g[rows % 3 == 0] *= np.float32(1e-30)
        extra = rows[rows % 3 == 1]
        g[extra, (g[extra] == 0).argmax(-1)] = np.float32(1e-30)
    return x, g


def _experts(rng):
    d, f, e = EDGE_D, EDGE_F, EDGE_E
    return ((rng.standard_normal((e, d, f)) / d ** 0.5).astype(np.float32),
            (rng.standard_normal((e, d, f)) / d ** 0.5).astype(np.float32),
            (rng.standard_normal((e, f, d)) / f ** 0.5).astype(np.float32))


def _rel_close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("t", EDGE_T)
def test_plain_moe_matches_pallas_at_tile_edges(t, routing):
    rng = np.random.default_rng(t)
    x, g = _routing(rng, t, routing)
    ws = _experts(rng)
    want = moe_experts_pallas(*(jnp.asarray(a) for a in (x, g, *ws)),
                              block_t=128, interpret=True)
    got = ref.moe_experts(*(torch.from_numpy(a) for a in (x, g, *ws)))
    _rel_close(got.numpy(), want, REL)


def _kept_pairs(x, g, wg, wu, wd):
    """The card's algorithm in float32 on the CPU: each expert's products
    over its kept rows only (ascending tokens), then per token the kept
    experts' y * g added in expert order from +0."""
    acc = torch.zeros(x.shape, dtype=torch.float32)
    for e in range(wg.shape[0]):
        rows = torch.nonzero(g[:, e] != 0).flatten()
        xe = x[rows].float()
        h = (torch.nn.functional.silu(xe @ wg[e].float())
             * (xe @ wu[e].float())).to(x.dtype)
        y = h.float() @ wd[e].float()
        acc[rows] = acc[rows] + y * g[rows, e:e + 1].float()
    return acc.to(x.dtype)


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("t", EDGE_T)
def test_kept_pairs_sum_equals_the_dense_plain_version(t, routing):
    """Dropping the zero-gate pairs leaves the float32 sum as the dense
    plain version takes it (1e-6: the CPU's products over fewer rows may
    round apart), every token's row on its own scale."""
    rng = np.random.default_rng(100 + t)
    x, g = _routing(rng, t, routing)
    args = [torch.from_numpy(a) for a in (x, g, *_experts(rng))]
    got, want = _kept_pairs(*args), ref.moe_experts(*args)
    for r in range(t):
        _rel_close(got[r].numpy(), want[r].numpy(), 1e-6)


def _load_chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports numpy alone)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_chip_moe_routings_are_what_they_say(dtype):
    """``chip_smoke._moe_routings`` at 16 tokens, 8 experts, top-2."""
    gen = torch.Generator().manual_seed(5)
    randn = CS._randn(torch, gen, dtype, "cpu")
    t, d, e, k = 16, 32, 8, 2
    r = CS._moe_routings(torch, randn(t, d), randn(d, e), k, dtype)
    assert tuple(r) == CS.MOE_ROUTINGS == ROUTINGS
    kept = {n: (g != 0) for n, g in r.items()}
    assert (kept["router"].sum(1) >= k).all()
    assert not kept["no token keeps expert 0"][:, 0].any()
    assert (kept["all on experts 0..k-1"][:, :k].all()
            and not kept["all on experts 0..k-1"][:, k:].any())
    assert (kept["ties keep 2k"].sum(1) >= 2 * k).all()
    tiny, g = r["tiny kept gates"].float(), r["router"].float()
    rows = torch.arange(t)
    assert (kept["tiny kept gates"][rows % 3 == 0]
            == kept["router"][rows % 3 == 0]).all()
    assert tiny[rows % 3 == 0].abs().max() < 1e-28
    assert (kept["tiny kept gates"].sum(1)[rows % 3 == 1]
            == kept["router"].sum(1)[rows % 3 == 1] + 1).all()
    assert (tiny[rows % 3 == 2] == g[rows % 3 == 2]).all()


def test_chip_row_error_catches_a_dropped_row_of_tiny_gates():
    """``_row_rel`` holds each row to its own scale: a kernel that dropped
    the pairs of a row whose gates are all tiny is off by 1 there, though
    the whole-tensor error is 1e-30 of the scale."""
    rng = np.random.default_rng(9)
    x, g = _routing(rng, 16, "tiny kept gates")
    args = [torch.from_numpy(a) for a in (x, g, *_experts(rng))]
    want = ref.moe_experts(*args)
    dropped = want.clone()
    dropped[0] = 0
    assert CS._row_rel(want, want) == 0.0
    assert CS._row_rel(dropped, want) == 1.0
    assert CS._rel(dropped, want) < 1e-20
