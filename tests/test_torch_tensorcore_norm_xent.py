"""K3 (``rmsnorm_matmul``), its int8 twin K10a and K11
(``streamed_xent_parts``) on the tensor cores, on the CPU.

Their CUDA code runs only on the card (``chip_smoke.py``'s ``tensorcore``
phase holds it there against the plain versions, and K3's and K10a's rows
bit for bit at 1..64 rows).  Here: K3's split plan (row invariance up to
64 rows) and K11's vocab plan, the route each dtype takes to its C entry
point and the arguments it passes (a fake library stands in for the
build), the profile's attribution of the new ``__global__`` functions, and
the plain versions against the interpret-mode Pallas kernels at the new
kernels' tile edges (64-row and 128-column tiles, 128-column vocab tiles)
on numpy-seeded float32 inputs, at a relative 1e-5 (the two sum in
different orders).
"""

import functools
import importlib
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import rmsnorm_matmul as j_rmsnorm_matmul
from repro.kernels import streamed_xent_loss as j_xent_loss
from repro.kernels import streamed_xent_parts as j_xent_parts
from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.common import (MMA_BN, ROW_INVARIANT_T, cdiv,
                                       mma_plan)
from repro_torch.kernels.streamed_xent import MMA_BT, xent_mma_plan
from repro_torch.models.layers import quantize_channelwise

from test_torch_tensorcore import (_FakeLib, _global_functions,
                                   _own_kernels)

bm_mod = importlib.import_module("repro_torch.kernels.block_matmul")
k3_mod = importlib.import_module("repro_torch.kernels.rmsnorm_matmul")
xent_mod = importlib.import_module("repro_torch.kernels.streamed_xent")
BF16, F32 = torch.bfloat16, torch.float32
REL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
# (D, N) of every rmsnorm_matmul call on a path: llama3-8b's q / o-sized
# and k, v projections and LM head; granite-moe-3b's; zamba2-2.7b's shared
# block's q/k/v and LM head; granite-moe-1b's training projections; an
# unaligned shape.
PATH_DN = [(4096, 4096), (4096, 1024), (4096, 128256), (1536, 1536),
           (1536, 512), (1536, 49408), (2560, 2560), (2560, 32000),
           (1024, 1024), (1024, 512), (1000, 1001)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("d,n", PATH_DN)
def test_k3_split_depends_on_the_weight_alone_up_to_64_rows(d, n, sms):
    """The wrapper's plan: the same K split at every row count 1..64 (a
    verify row then sums what its decode row sums, in the same order);
    splits cover D in whole 64-deep K tiles at every row count."""
    first = mma_plan(1, d, n, sms)[1:]
    for t in range(2, ROW_INVARIANT_T + 1):
        assert mma_plan(t, d, n, sms)[1:] == first, t
    for t in (1, 17, 64, 65, 128, 1000, 4096):
        _, bk, kps, splits = mma_plan(t, d, n, sms)
        assert kps % bk == 0
        assert (splits - 1) * kps < d <= splits * kps


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("t,vp", [(8192, 50432), (4096, 128256),
                                  (4096, 49408), (4096, 32000),
                                  (4096, 65536), (1000, 50264), (300, 1001),
                                  (1, 128), (129, 129)])
def test_xent_plan_covers_every_vocab_tile_once(t, vp, sms):
    per, splits = xent_mma_plan(t, vp, sms)
    n_tiles = cdiv(vp, MMA_BN)
    ranges = [range(z * per, min(n_tiles, (z + 1) * per))
              for z in range(splits)]
    assert all(len(r) >= 1 for r in ranges)
    assert [i for r in ranges for i in r] == list(range(n_tiles))
    # About eight blocks per SM where the vocab allows it.
    tiles = cdiv(t, MMA_BT)
    assert tiles * splits >= min(8 * sms, tiles * n_tiles) / 2


@pytest.fixture
def card_route(monkeypatch):
    """Force the CUDA route for CPU tensors, with every library a
    ``_FakeLib``; returns the list of recorded launches."""
    calls = []
    for mod in (k3_mod, xent_mod):
        monkeypatch.setattr(mod, "kernel_path", lambda t: "cuda")
        monkeypatch.setattr(mod, "sm_count", lambda device: 132)
        mod._entry.cache_clear()
    monkeypatch.setattr(bm_mod, "_WORKSPACE", {})
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(name, calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    yield calls
    for mod in (k3_mod, xent_mod):
        mod._entry.cache_clear()


def _k3(dtype, t=4, d=64, n=40, w8=False):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(t, d, generator=gen).to(dtype)
    s = torch.zeros(d, dtype=dtype)
    w = torch.randn(d, n, generator=gen)
    if w8:
        c, ws = quantize_channelwise(w)
        return K.rmsnorm_matmul_w8(x, s, c, w_scale=ws)
    return K.rmsnorm_matmul(x, s, w.to(dtype))


def _xent(dtype, t=20, d=64, vp=200):
    gen = torch.Generator().manual_seed(4)
    h = torch.randn(t, d, generator=gen).to(dtype)
    w = torch.randn(d, vp, generator=gen).to(dtype)
    y = torch.randint(0, vp, (t,), generator=gen, dtype=torch.int32)
    return K.streamed_xent_parts(h, w, y, vocab_size=vp - 10)


ROUTES = {
    # case: (call, library, symbol, wrapper whose count rises)
    "K3 bf16": (functools.partial(_k3, BF16), "rmsnorm_matmul",
                "repro_rmsnorm_matmul_mma_bf16", K.rmsnorm_matmul),
    "K3 bf16, 100 rows": (functools.partial(_k3, BF16, 100),
                          "rmsnorm_matmul", "repro_rmsnorm_matmul_mma_bf16",
                          K.rmsnorm_matmul),
    "K3 f32": (functools.partial(_k3, F32), "rmsnorm_matmul",
               "repro_rmsnorm_matmul_f32", K.rmsnorm_matmul),
    "K10a bf16": (functools.partial(_k3, BF16, w8=True), "rmsnorm_matmul",
                  "repro_rmsnorm_matmul_w8_mma_bf16", K.rmsnorm_matmul_w8),
    "K10a f32": (functools.partial(_k3, F32, w8=True), "rmsnorm_matmul",
                 "repro_rmsnorm_matmul_w8_f32", K.rmsnorm_matmul_w8),
    "K11 bf16": (functools.partial(_xent, BF16), "streamed_xent",
                 "repro_streamed_xent_mma_bf16", K.streamed_xent_parts),
    "K11 f32": (functools.partial(_xent, F32), "streamed_xent",
                "repro_streamed_xent_f32", K.streamed_xent_parts),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_each_dtype_reaches_its_entry_point(card_route, case):
    call, lib, symbol, counter = ROUTES[case]
    before = counter.launches
    for i in range(1, 3):
        call()
        assert [(c[0], c[1]) for c in card_route] == [(lib, symbol)] * i
        assert counter.launches == before + i


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("t,d,n", [(4, 4096, 4096), (20, 4096, 1024),
                                   (1, 4096, 128256), (64, 1536, 512),
                                   (65, 1536, 1536), (4096, 1024, 1024),
                                   (4, 1000, 1001), (4, 64, 40)])
def test_bf16_k3_passes_its_plan(card_route, t, d, n, w8):
    """The tensor-core entry point gets ``mma_plan``'s split, K5's
    workspace only when it splits, a row-statistics buffer of T floats
    only above 64 rows, and the scalar-load flag exactly where a row is not
    a whole number of 16-byte vectors (int8 codes: 16 per vector)."""
    x = torch.zeros(t, d, dtype=BF16)
    s = torch.zeros(d, dtype=BF16)
    if w8:
        K.rmsnorm_matmul_w8(x, s, torch.zeros(d, n, dtype=torch.int8),
                            w_scale=torch.ones(n))
    else:
        K.rmsnorm_matmul(x, s, torch.zeros(d, n, dtype=BF16))
    (_, _, args), = card_route
    part, ctr, rstd = args[5], args[6], args[7]
    bm, _, k_per_split, splits = mma_plan(t, d, n, 132)
    aligned = d % 8 == 0 and n % (16 if w8 else 8) == 0
    assert args[8:14] == (t, d, n, k_per_split, splits, int(aligned))
    assert (args[3] is not None) == w8
    assert (part is not None) == (ctr is not None) == (splits > 1)
    assert (rstd is not None) == (t > ROW_INVARIANT_T)
    if splits > 1:
        part_ws, ctr_ws = bm_mod._WORKSPACE[x.device]
        assert (part, ctr) == (part_ws.data_ptr(), ctr_ws.data_ptr())
        assert part_ws.numel() >= splits * t * n
        assert ctr_ws.numel() >= cdiv(n, MMA_BN) * cdiv(t, bm)


@pytest.mark.parametrize("t,d,vp", [(4096, 4096, 128256), (1000, 1024, 50264),
                                    (300, 1000, 1001)])
def test_bf16_xent_passes_its_plan(card_route, t, d, vp):
    h = torch.zeros(t, d, dtype=BF16)
    K.streamed_xent_parts(h, torch.zeros(d, vp, dtype=BF16),
                          torch.zeros(t, dtype=torch.int32),
                          vocab_size=vp - 1)
    (_, _, args), = card_route
    per, splits = xent_mma_plan(t, vp, 132)
    assert args[6:13] == (t, d, vp, vp - 1, per, splits,
                          int(d % 8 == 0 and vp % 8 == 0))


def test_profile_attributes_the_new_kernels():
    names = _global_functions()
    new = {"rmsnorm_mma_kernel", "rmsnorm_rstd_kernel", "xent_mma_kernel"}
    assert new <= names
    stage = dict(_own_kernels())
    for name in new:
        hits = [k for k in stage if k in name]
        assert len(hits) == 1, (name, hits)
    assert stage["rmsnorm_mma_kernel"] == stage["rmsnorm_rstd_kernel"]


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# D and N not multiples of 64 or 128.
EDGE_D, EDGE_N = 200, 136


@pytest.mark.parametrize("w8", [False, True])
@pytest.mark.parametrize("t", [1, 16, 17, 64, 65, 128])
def test_plain_k3_matches_pallas_at_tile_edges(t, w8):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, EDGE_D)).astype(np.float32)
    s = (0.1 * rng.standard_normal(EDGE_D)).astype(np.float32)
    w = (rng.standard_normal((EDGE_D, EDGE_N)) / EDGE_D ** 0.5
         ).astype(np.float32)
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    if w8:
        c, ws = quantize_channelwise(torch.from_numpy(w))
        got = K.rmsnorm_matmul_w8(xt, st, c, w_scale=ws)
        want = j_rmsnorm_matmul(jnp.asarray(x), jnp.asarray(s),
                                jnp.asarray(c.numpy()),
                                w_scale=jnp.asarray(ws.numpy()),
                                interpret=True)
    else:
        got = K.rmsnorm_matmul(xt, st, torch.from_numpy(w))
        want = j_rmsnorm_matmul(jnp.asarray(x), jnp.asarray(s),
                                jnp.asarray(w), interpret=True)
    _rel_close(got.numpy(), want)


MASKED = -1e29          # a gold at or below this is the -1e30 mask


@pytest.mark.parametrize("t,vp,vocab", [(130, 200, 190), (64, 136, 136),
                                        (17, 264, 250)])
def test_plain_xent_matches_pallas_at_tile_edges(t, vp, vocab):
    """Vp not a whole number of 128-column tiles; about a tenth of the
    labels on padded columns (their masked logit is the gold: masked in
    both), a tenth ignored (-100: clamped for the parts, left out of the
    loss).  lse, the finite golds and a loss over labels off the padded
    columns, each on its own scale."""
    rng = np.random.default_rng(vp)
    d = 72
    hidden = rng.standard_normal((t, d)).astype(np.float32)
    head = (0.1 * rng.standard_normal((d, vp))).astype(np.float32)
    labels = rng.integers(0, vocab, t).astype(np.int32)
    on_pad = np.zeros(t, bool)
    if vp > vocab:
        on_pad[rng.permutation(t)[:t // 10 + 1]] = True
        labels[on_pad] = rng.integers(vocab, vp, on_pad.sum())
    lse, gold = K.streamed_xent_parts(
        torch.from_numpy(hidden), torch.from_numpy(head),
        torch.from_numpy(labels), vocab_size=vocab)
    j_lse, j_gold = j_xent_parts(jnp.asarray(hidden), jnp.asarray(head),
                                 jnp.asarray(labels), vocab_size=vocab,
                                 interpret=True)
    gold, j_gold = gold.numpy(), np.asarray(j_gold)
    _rel_close(lse.numpy(), j_lse)
    assert ((gold <= MASKED) == on_pad).all()
    assert ((j_gold <= MASKED) == on_pad).all()
    _rel_close(gold[~on_pad], j_gold[~on_pad])
    labels[on_pad] = rng.integers(0, vocab, on_pad.sum())
    labels[rng.permutation(t)[:t // 10 + 1]] = -100
    got = K.streamed_xent_loss(torch.from_numpy(hidden),
                               torch.from_numpy(head),
                               torch.from_numpy(labels), vocab_size=vocab)
    want = j_xent_loss(jnp.asarray(hidden), jnp.asarray(head),
                       jnp.asarray(labels), vocab_size=vocab,
                       interpret=True)
    assert 1 < float(want) < 10
    _rel_close(got.numpy(), want)


def _load_chip_smoke():
    """``chip_smoke.py`` as a module (its top level imports numpy alone)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()


def _xent_fault(h, w, y, vocab):
    """(the plain version with the vocabulary mask left off its sum, the
    plain version): no label on a padded column, so only lse differs."""
    from repro_torch.kernels import ref
    return (ref.xent_parts_ref(h, w, y, w.shape[1]),
            ref.xent_parts_ref(h, w, y, vocab))


# The checks below at D = 64: the logits' spread (h ~ N(0, 1), W ~ N(0,
# 1/D)) does not depend on D, and the vocabulary sizes are the paths'.
CHECK_D = 64


@pytest.mark.parametrize("vp,vocab", sorted(
    {c[3:] for c in CS.TC_XENT if c[3] > c[4]}))
def test_chip_xent_check_catches_a_sum_over_padded_columns(vp, vocab):
    """``chip_smoke``'s K11 check (``_xent_err`` within
    ``XENT_TOL_NATS``) at each ``tensorcore`` vocabulary with Vp > vocab,
    on 16 tokens and that phase's head (``_xent_head``): the plain version
    passes against itself; left without the vocabulary mask, it is more
    than a nat off."""
    d = CHECK_D
    gen = torch.Generator().manual_seed(vp)
    randn = CS._randn(torch, gen, F32, "cpu")
    h = randn(16, d)
    w = CS._xent_head(torch, randn, d, vp, vocab)
    y = torch.randint(0, vocab, (16,), generator=gen, dtype=torch.int32)
    fault, want = _xent_fault(h, w, y, vocab)
    assert CS._xent_err(want, want) == 0.0
    assert CS._xent_err(fault, want) > 1.0


@pytest.mark.parametrize("vocab", [50257, 49155])
def test_chip_xent_check_catches_it_at_the_kernel_phase(vocab):
    """The same fault at the ``kernel`` phase's gpt2 and granite-moe-1b
    heads (``xent_cases``: padded columns drawn like the real ones) is
    still more than twice ``XENT_TOL_NATS`` off."""
    from repro_torch.models.params import padded_vocab
    d = CHECK_D
    gen = torch.Generator().manual_seed(vocab)
    randn = CS._randn(torch, gen, F32, "cpu")
    vp = padded_vocab(vocab)
    h, w = randn(16, d), randn(d, vp, scale=1 / d ** 0.5)
    y = torch.randint(0, vocab, (16,), generator=gen, dtype=torch.int32)
    fault, want = _xent_fault(h, w, y, vocab)
    assert CS._xent_err(fault, want) > 2 * CS.XENT_TOL_NATS


def test_chip_xent_check_holds_the_gold_mask():
    """A gold that lost its mask (a label on a padded column) is inf."""
    lse = torch.full((4,), 11.0)
    gold = torch.tensor([1.0, -1e30, 0.5, 2.0])
    assert CS._xent_err((lse, gold), (lse, gold)) == 0.0
    lost = gold.clone()
    lost[1] = 3.0
    assert CS._xent_err((lse, lost), (lse, gold)) == float("inf")
    assert CS._xent_err((lse, gold), (lse, lost)) == float("inf")
