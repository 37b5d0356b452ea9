"""The split paged attention kernels (K1 decode, K8 verify and their
code-pool twins K9a/K9b) on the CPU.

Their CUDA code runs only on the card (``chip_smoke.py``'s ``kernel`` and
``paged_split`` phases hold it there against the plain versions, row by
row and bit for bit).  Here: the partition plan, the route each wrapper
and dtype takes to its C entry point with the partition size and a
partials buffer of the stated size (a fake library stands in for the
build), and a float32 emulation of the kernel's partition-then-fold
arithmetic against the interpret-mode Pallas kernels at the boundary
lengths, with every verify row equal to decode at its length, bit for
bit, inside the emulation.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import paged_decode_attention as j_paged_decode
from repro.kernels import paged_verify_attention as j_paged_verify
from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.common import PAGED_PART, cdiv, paged_plan
from test_torch_tensorcore import _FakeLib


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


pa_mod = importlib.import_module("repro_torch.kernels.paged_attention")
P = PAGED_PART
CH = 32              # the kernel's tile: one position per lane
PS = 16              # the engine's page size
MAXP = 10            # an extent of 160 positions: partitions of 128 and 32
EXTENT = MAXP * PS
# Row lengths at the page, tile and partition edges, and the extent.
LENGTHS = (0, 1, 15, 16, 17, P - 1, P, P + 1, EXTENT)
W = 5                # a verify window (draft_len 4)


@pytest.mark.parametrize("extent", [0, 1, 16, P - 1, P, P + 1, EXTENT,
                                    1024, 2048, 2064])
def test_paged_plan_depends_on_the_extent_alone(extent):
    parts = paged_plan(extent)
    assert parts == cdiv(extent, P)
    assert parts * P >= extent > (parts - 1) * P or extent == parts == 0
    assert P % PS == 0 and P % CH == 0


@pytest.fixture
def card_route(monkeypatch):
    """Force the CUDA route for CPU tensors, with the library a
    ``_FakeLib``; returns the recorded launches and every tensor the
    wrapper allocated with ``torch.empty``."""
    calls, buffers = [], []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        buffers.append(t)
        return t

    monkeypatch.setattr(pa_mod, "kernel_path", lambda t: "cuda")
    pa_mod._entry.cache_clear()
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(name, calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", empty)
    yield calls, buffers
    pa_mod._entry.cache_clear()


def _operands(dtype, code, w, hq, hkv, d, b=4, maxp=MAXP):
    """q [b, w, hq, d], pools of 1 + b * maxp pages (codes and float32
    scales with ``code``), a page table and a per-slot int32 operand."""
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(b, w, hq, d, generator=gen).to(dtype)
    pool = torch.randn(1 + b * maxp, PS, hkv, d, generator=gen)
    table = (torch.randperm(b * maxp, generator=gen) + 1).reshape(
        b, maxp).to(torch.int32)
    base = torch.tensor([37, 0, 129, 5][:b], dtype=torch.int32)
    if code is None:
        return q, pool.to(dtype), pool.to(dtype), table, base, {}
    c = pool.clamp(-1, 1).to(code)
    sc = torch.ones(1 + b * maxp, hkv)
    return q, c, c, table, base, dict(k_scale=sc, v_scale=sc)


BF16, F32 = torch.bfloat16, torch.float32
WRAPPERS = {
    # name: (wrapper, window rows, code type)
    "decode": (K.paged_decode_attention, 1, None),
    "verify": (K.paged_verify_attention, W, None),
    "decode_q int8": (K.paged_decode_attention_q, 1, torch.int8),
    "verify_q fp8": (K.paged_verify_attention_q, W, torch.float8_e4m3fn),
}
SYMBOLS = {None: "", torch.int8: "q_", torch.float8_e4m3fn: "q_"}


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", sorted(WRAPPERS))
def test_each_wrapper_passes_the_partition_and_its_partials(card_route,
                                                            case, dtype):
    calls, buffers = card_route
    fn, w, code = WRAPPERS[case]
    hq, hkv, d = 8, 2, 128
    q, kp, vp, table, base, sc = _operands(dtype, code, w, hq, hkv, d)
    tname = "bf16" if dtype == BF16 else "f32"
    suffix = {None: "", torch.int8: "_i8", torch.float8_e4m3fn: "_fp8"}
    symbol = f"repro_paged_window_{SYMBOLS[code]}{tname}{suffix[code]}"
    before = fn.launches
    for i in range(1, 3):
        del buffers[:]
        fn(q, kp, vp, table, base, **sc)
        assert [(c[0], c[1]) for c in calls] == [
            ("paged_attention", symbol)] * i
        assert fn.launches == before + i
        args = calls[-1][2]
        n_ptrs = 9 if code is not None else 7
        part_ptr = args[n_ptrs - 2]
        ints, window = args[n_ptrs:-3], args[-3]
        assert window == 0
        b, hkv_, g, w_, extra, d_, ps, maxp, part_size = ints
        assert (b, hkv_, g, w_, extra, d_, ps, maxp) == (
            4, hkv, hq // hkv, w, int(w > 1), d, PS, MAXP)
        assert part_size == PAGED_PART
        part, = [t for t in buffers if t.data_ptr() == part_ptr]
        assert part.dtype == torch.float32
        assert part.numel() == b * w * hq * paged_plan(MAXP * PS) * (d + 2)


def test_the_partition_size_does_not_follow_the_batch(card_route):
    """One slot alone or in a batch of four, any window, any lengths: the
    entry point gets the same partition size and extent."""
    calls, _ = card_route
    for b, w in ((1, 1), (4, 1), (4, W), (2, 3)):
        q, kp, vp, table, base, _ = _operands(BF16, None, w, 8, 2, 64, b=b)
        fn = K.paged_decode_attention if w == 1 else K.paged_verify_attention
        fn(q, kp, vp, table, base)
    # (..., maxp, part_size, window, scale, stream)
    assert {c[2][-4] for c in calls} == {PAGED_PART}
    assert {c[2][-5] for c in calls} == {MAXP}


def test_an_unaligned_pool_is_refused(card_route):
    """The kernel copies pool rows in 16-byte vectors: a pool that starts
    off a 16-byte boundary is refused before any launch."""
    calls, _ = card_route
    q, kp, vp, table, base, _ = _operands(BF16, None, 1, 8, 2, 64)
    odd = torch.zeros(kp.numel() + 1, dtype=BF16)[1:].view(kp.shape)
    with pytest.raises(ValueError, match="16-byte"):
        K.paged_decode_attention(q, odd, vp, table, base)
    assert not calls


# ---------------------------------------------------------------------- #
# The kernel's arithmetic, emulated in float32
# ---------------------------------------------------------------------- #

def _fma(a, b, c):
    """float32 fma: the product exact in float64, one rounding to float32
    after the add (up to a double rounding, which an emulation of the
    algorithm may carry)."""
    return (a.double() * b.double() + c.double()).float()


def _lane_sum(x):
    """The warp's butterfly sum over its 32 lanes (last dim)."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _emulate(q, kp, vp, table, base, extra, *, scale, k_scale=None,
             v_scale=None):
    """``csrc/paged_attention.cuh`` in float32 torch ops, one output row per
    (slot, window row, query head): partitions of ``PAGED_PART`` positions
    of the slot's extent, 32-position tiles in each, a sequential dot over
    D per score, the online softmax per tile (a row skips the tiles at or
    past its length), then the fold of the partitions that start below the
    row's length, in order.  Every operation is elementwise or a reduction
    over one row, so a row's result depends on its own operands alone."""
    b, w, hq, d = q.shape
    _, ps, hkv, _ = kp.shape
    g = hq // hkv
    extent = table.shape[1] * ps
    parts = paged_plan(extent)
    tbl = table.long()

    def dense(pool, sc):
        x = pool.float()[tbl]                     # [B, maxp, ps, Hkv, D]
        if sc is not None:
            x = x * sc.float()[tbl][:, :, None, :, None]
        x = x.reshape(b, extent, hkv, d).permute(0, 2, 1, 3)
        pad = parts * P - extent                  # zero-filled positions
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        # [B, Hkv, S, D] -> one [S, D] per output row (b, w, hq).
        x = x[:, None, :, None].expand(b, w, hkv, g, parts * P, d)
        return x.reshape(b * w * hq, parts * P, d)

    kd, vd = dense(kp, k_scale), dense(vp, v_scale)
    qf = q.float().reshape(-1, d) * scale                        # [R, D]
    lens = (base.long()[:, None] + extra + torch.arange(w)[None])
    lens = lens.clamp(0, extent)[:, :, None].expand(b, w, hq).reshape(-1)
    r = qf.shape[0]
    neg = torch.full((r,), -1e30)
    partials = []
    for p in range(parts):
        m, l, acc = neg.clone(), torch.zeros(r), torch.zeros(r, d)
        for c0 in range(p * P, (p + 1) * P, CH):
            kt, vt = kd[:, c0:c0 + CH], vd[:, c0:c0 + CH]
            s = torch.zeros(r, CH)
            for c in range(d):
                s = _fma(qf[:, c, None], kt[:, :, c], s)
            pos = c0 + torch.arange(CH)
            valid = pos[None] < lens[:, None]
            sv = torch.where(valid, s, -1e30)
            m_new = torch.maximum(m, sv.amax(dim=-1))
            pr = torch.where(valid, torch.exp(sv - m_new[:, None]), 0.0)
            corr = torch.exp(m - m_new)
            l_new = _fma(l, corr, _lane_sum(pr))
            a_new = acc * corr[:, None]
            for j in range(CH):
                a_new = _fma(pr[:, j, None], vt[:, j], a_new)
            live = c0 < lens
            m = torch.where(live, m_new, m)
            l = torch.where(live, l_new, l)
            acc = torch.where(live[:, None], a_new, acc)
        partials.append((m, l, acc))
    mx = neg.clone()
    for p, (m, _, _) in enumerate(partials):
        mx = torch.where(p * P < lens, torch.maximum(mx, m), mx)
    total, a = torch.zeros(r), torch.zeros(r, d)
    for p, (m, l, acc) in enumerate(partials):
        live = p * P < lens
        e = torch.exp(m - mx)
        total = torch.where(live, _fma(l, e, total), total)
        a = torch.where(live[:, None], _fma(acc, e[:, None], a), a)
    out = a / torch.clamp(total, min=1e-30)[:, None]
    return out.reshape(b, w, hq, d)


def _inputs(rng, w, g, code, d=32, hkv=1):
    """Slots at ``LENGTHS`` (decode lengths, or verify offsets whose row 0
    sees each length and whose last row reaches at most the extent), pools
    of 1 + slots * MAXP pages with the NULL page 0 in the table's unused
    tail, and int8 codes with float32 scales per (page, KV head)."""
    b = len(LENGTHS)
    pages = 1 + b * MAXP
    q = rng.standard_normal((b, w, hkv * g, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((pages, PS, hkv, d)).astype(np.float32)
              for _ in range(2))
    table = (rng.permutation(pages - 1)[:b * MAXP] + 1).reshape(b, MAXP)
    table = table.astype(np.int32)
    table[0, 1:] = 0                      # an idle slot's unallocated tail
    scales = {}
    if code is not None:
        kp, vp = (np.clip(np.round(x * 40), -127, 127).astype(np.int8)
                  for x in (kp, vp))
        scales = {k: (rng.random((pages, hkv)) * 0.05 + 0.01).astype(
            np.float32) for k in ("k_scale", "v_scale")}
    if w == 1:
        base = np.array(LENGTHS, np.int32)
    else:
        base = np.array([n - 1 for n in LENGTHS[:-1]] + [EXTENT - w],
                        np.int32)
    return q, kp, vp, table, base, scales


def _rel(got, want):
    want = torch.from_numpy(np.array(want))
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("code", [None, "int8"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("w", [1, W])
def test_emulated_split_matches_pallas_at_the_boundary_lengths(w, g, code):
    rng = np.random.default_rng(100 * w + 10 * g + (code is not None))
    q, kp, vp, table, base, scales = _inputs(rng, w, g, code)
    scale = 1.0 / np.sqrt(q.shape[-1])
    pallas = j_paged_decode if w == 1 else j_paged_verify
    want = pallas(*(jnp.asarray(a) for a in (q, kp, vp, table, base)),
                  **{k: jnp.asarray(v) for k, v in scales.items()})
    got = _emulate(*(torch.from_numpy(a) for a in (q, kp, vp, table, base)),
                   extra=int(w > 1), scale=scale,
                   **{k: torch.from_numpy(v) for k, v in scales.items()})
    assert _rel(got, want) <= 1e-6
    # Rows of length 0 (decode slot 0, verify slot 0 row 0) give zeros.
    assert torch.count_nonzero(got[0, 0]) == 0


@pytest.mark.parametrize("code", [None, "int8"])
@pytest.mark.parametrize("g", [1, 4])
def test_emulated_verify_rows_equal_decode_at_their_lengths(g, code):
    """Every verify row equals the decode emulation at ``q_off + w + 1``
    bit for bit: a row's operations follow from its length alone, as the
    fixed partitions and the length-driven skips make them."""
    rng = np.random.default_rng(7 + g)
    q, kp, vp, table, base, scales = _inputs(rng, W, g, code)
    t = {k: torch.from_numpy(v) for k, v in scales.items()}
    q, kp, vp, table, base = (torch.from_numpy(a)
                              for a in (q, kp, vp, table, base))
    scale = 1.0 / np.sqrt(q.shape[-1])
    verify = _emulate(q, kp, vp, table, base, 1, scale=scale, **t)
    b = q.shape[0]
    # Window row w of slot i as a decode slot of its own, the slots in
    # another order: i-major for verify, w-major here.
    dq = q.transpose(0, 1).reshape(W * b, 1, *q.shape[2:])
    dtable = table.repeat(W, 1)
    dlens = torch.cat([base + w + 1 for w in range(W)]).to(torch.int32)
    decode = _emulate(dq, kp, vp, dtable, dlens, 0, scale=scale, **t)
    assert torch.equal(decode.reshape(W, b, *q.shape[2:]).transpose(0, 1),
                       verify)
