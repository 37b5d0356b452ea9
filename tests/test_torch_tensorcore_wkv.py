"""K14 (``wkv6``) as a sequence-split scan on the tensor cores, on the CPU.

Its CUDA code runs only on the card (``chip_smoke.py``'s ``tensorcore``
phase holds it there against the plain version, y and the final state
each on its own scale, and bit for bit across prompt lengths, chunks and
batches: ``tensorcore_wkv``; ``chip_phases.py wkv_hashes`` hashes the
float32 kernel's outputs against another tree's).  Here: ``wkv_plan``'s
segments, the route each dtype takes to its C entry point with the plan's
arguments and a workspace (a fake library stands in for the build), the
refusals, the profile's attribution of the new kernels, and a float32
model of the bf16 algorithm (64-token segments from position 0, walked in
sub-blocks of 16 tokens: each segment's own end state from suffix decays,
the pass across segments, the outputs from prefix decays and exact in-block
scores, every hi + lo bf16 split emulated) against the interpret-mode
Pallas kernel at relative 1e-4, with decays of exactly 0, exactly 1 and
e^-40 among the inputs; the model's rows are bit-equal across prompt
lengths, chunks and batches.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.rwkv6_wkv import wkv6_pallas
from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.common import WKV_SEG, WKV_SUB, cdiv, wkv_plan

from test_torch_tensorcore import _FakeLib, _global_functions, _own_kernels


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


wkv_mod = importlib.import_module("repro_torch.kernels.rwkv6_wkv")
BF16, F32 = torch.bfloat16, torch.float32
REL = 1e-4


@pytest.mark.parametrize("s", [1, 15, 16, 17, 37, 63, 64, 65, 128, 129, 999,
                               1000, 2048, 4097])
def test_wkv_plan_covers_the_sequence_in_fixed_segments(s):
    """Segments of ``WKV_SEG`` tokens from position 0 cover [0, S) once,
    the last one partial where WKV_SEG does not divide S; the segment
    length is the same at every S, and a whole number of sub-blocks."""
    seg, nseg = wkv_plan(s)
    assert seg == WKV_SEG == 64 and seg % WKV_SUB == 0
    assert nseg == cdiv(s, seg)
    rows = [min(seg, s - g * seg) for g in range(nseg)]
    assert all(r > 0 for r in rows) and sum(rows) == s
    assert rows[:-1] == [seg] * (nseg - 1)
    assert (rows[-1] < seg) == (s % seg != 0)


@pytest.fixture
def card_route(monkeypatch):
    """Force the CUDA route for CPU tensors, with every library a
    ``_FakeLib``; returns (recorded launches, recorded allocations)."""
    calls, allocs = [], []
    # Fake launches count; the count goes back to its value afterwards.
    monkeypatch.setattr(wkv_mod.wkv6, "launches", wkv_mod.wkv6.launches)
    monkeypatch.setattr(wkv_mod, "kernel_path", lambda t: "cuda")
    wkv_mod._entry.cache_clear()
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(name, calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty

    def record(*shape, **kw):
        out = empty(*shape, **kw)
        allocs.append((tuple(out.shape), out.dtype, out.data_ptr()))
        return out

    monkeypatch.setattr(wkv_mod.torch, "empty", record)
    yield calls, allocs
    wkv_mod._entry.cache_clear()


def _args(dtype, b=1, s=37, h=3, n=64):
    gen = torch.Generator().manual_seed(s)
    r, k, v = (torch.randn(b, s, h, n, generator=gen).to(dtype)
               for _ in range(3))
    w = torch.rand(b, s, h, n, generator=gen)
    return r, k, v, w, torch.randn(h, n, generator=gen)


@pytest.mark.parametrize("b,s,chunk,n", [(1, 1, 64, 64), (1, 37, 37, 64),
                                         (1, 999, 1, 64), (1, 1000, 8, 64),
                                         (2, 2048, 64, 64), (2, 65, 5, 16),
                                         (1, 129, 43, 128), (3, 64, 64, 32)])
def test_bf16_wkv_passes_the_plan_and_a_workspace(card_route, b, s, chunk,
                                                  n):
    """bf16: ``repro_wkv6_seg_bf16`` with ``wkv_plan(S)``'s segment length
    and count whatever the chunk, and one float32 workspace of every
    segment's state and decay, allocated by the call (after the final
    state)."""
    calls, allocs = card_route
    before = K.wkv6.launches
    r, k, v, w, u = _args(BF16, b, s, n=n)
    y, state = K.wkv6(r, k, v, w, u, chunk=chunk)
    (lib, symbol, args), = calls
    assert (lib, symbol) == ("rwkv6_wkv", "repro_wkv6_seg_bf16")
    seg, nseg = wkv_plan(s)
    assert args[9:15] == (b, s, 3, n, seg, nseg)
    assert args[4:8] == (u.data_ptr(), 0, y.data_ptr(), state.data_ptr())
    (hshape, hdt, hp), (wshape, wdt, wp) = allocs
    assert tuple(y.shape) == (b, s, 3, n) and y.dtype == BF16
    assert (hshape, hdt, args[7]) == ((b, 3, n, n), F32, hp)
    assert wdt == F32 and args[8] == wp
    assert wshape == (b * 3 * nseg * (n * n + n),)
    assert all(a % 16 == 0 for a in args[:4])
    assert K.wkv6.launches == before + 1


@pytest.mark.parametrize("u_dt,flag,converted", [
    (BF16, 1, False), (F32, 0, False), (torch.float16, 0, True)])
def test_bf16_wkv_reads_u_as_it_is(card_route, u_dt, flag, converted):
    """The bf16 kernels take the bonus u as it is, bf16 (flag 1) or
    float32 (flag 0), with no launch of its own; another dtype is
    converted to float32 first."""
    calls, _ = card_route
    r, k, v, w, u = _args(BF16, 1, 65)
    u = u.to(u_dt)
    K.wkv6(r, k, v, w, u, chunk=13)
    (_, _, args), = calls
    assert args[5] == flag
    assert (args[4] == u.data_ptr()) != converted


@pytest.mark.parametrize("chunk", [1, 8, 40, 125])
def test_f32_wkv_keeps_its_entry(card_route, chunk):
    """float32: ``repro_wkv6_f32`` with its arguments as before (the
    chunk is not passed), no workspace."""
    calls, allocs = card_route
    r, k, v, w, u = _args(F32, 1, 1000, n=32)
    y, state = K.wkv6(r, k, v, w, u, chunk=chunk)
    (lib, symbol, args), = calls
    assert (lib, symbol) == ("rwkv6_wkv", "repro_wkv6_f32")
    assert len(args) == 12
    assert args[:3] == (r.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[5:11] == (y.data_ptr(), state.data_ptr(), 1, 1000, 3, 32)
    assert [shape for shape, _, _ in allocs] == [(1, 3, 32, 32)]


@pytest.mark.parametrize("bad", ["N 48", "N 8", "chunk 7", "w bf16",
                                 "mixed dtypes"])
def test_wkv_refusals(card_route, bad):
    """Both dtypes take head sizes 16, 32, 64 and 128 alone; a chunk that
    does not divide S is refused, as the reference asserts; r, k and v
    share a dtype; w is float32.  Nothing launches."""
    calls, _ = card_route
    n = {"N 48": 48, "N 8": 8}.get(bad, 64)
    r, k, v, w, u = _args(BF16, 1, 24, n=n)
    if bad == "w bf16":
        w = w.to(BF16)
    if bad == "mixed dtypes":
        k = k.float()
    with pytest.raises((ValueError, TypeError)):
        K.wkv6(r, k, v, w, u, chunk=7 if bad == "chunk 7" else 8)
    assert calls == []


def test_profile_attributes_the_segment_kernels_to_k14():
    names = _global_functions()
    seg_names = {"wkv_seg_state_kernel", "wkv_seg_carry_kernel",
                 "wkv_seg_out_kernel"}
    assert seg_names | {"wkv6_kernel"} <= names
    stage = dict(_own_kernels())
    for name in seg_names | {"wkv6_kernel"}:
        hits = [k for k in stage if k in name]
        assert len(hits) == 1 and "K14" in stage[hits[0]], (name, hits)
    assert stage["wkv_seg_"] != stage["wkv6_kernel"]


# --------------------------------------------------------------------- #
# A float32 model of the sequence-split algorithm
# --------------------------------------------------------------------- #

def _split(t: torch.Tensor):
    """hi + lo bf16 planes of a float32 tensor, as float32."""
    hi = t.to(BF16).float()
    return hi, (t - hi).to(BF16).float()


def _suffix(kk, ww):
    """k_t o w_{t+1} ... w_end for each t of the block (the product taken
    from the end, one factor at a time), and the block's whole decay."""
    q = torch.ones_like(kk[..., 0, :])
    kq = torch.empty_like(kk)
    for t in reversed(range(kk.shape[-2])):
        kq[..., t, :] = kk[..., t, :] * q
        q = q * ww[..., t, :]
    return kq, q


def wkv_model(r, k, v, w, u):
    """The bf16 kernel's algorithm in float32 (r, k, v as float32 holding
    the bf16 values the kernel reads; w the float32 decay; u [H, N]).
    Segments of ``wkv_plan``, tokens at or past S padded with r = k = v =
    0 and w = 1.  1. Each segment but the last: its own end state from
    zero and its decay D, walked in sub-blocks of 16 tokens: S^T <- S^T o
    Q_b + v^T (k o Q) with Q the suffix decay inside the sub-block (k o Q
    split hi + lo) and Q_b its end, D the product of the Q_b.  2. The pass
    across segments: S_in(1) = S_loc(0), S_in(g + 1) = S_in(g) o D_g +
    S_loc(g).  3. Per segment from S_in, in sub-blocks of 16 tokens from
    b: y^T = S^T (r o P(b, t-1))^T, both split (hi hi + hi lo + lo hi), +
    v^T A^T with A[t, tau] = sum_k r_t k_tau P(tau+1, t-1) below the
    diagonal and sum_k r_t u k_t on it (split); then S^T <- S^T o P(b,
    b+15) + v^T (k o P(tau+1, b+15)) (split).  The last segment's state is
    the final state."""
    bsz, s, h, n = r.shape
    seg, nseg = wkv_plan(s)
    pad = seg * nseg - s

    def lay(t, fill):
        t = t.permute(0, 2, 1, 3)
        return torch.cat([t, torch.full((bsz, h, pad, n), fill)], 2)

    r, k, v = (lay(t, 0.0) for t in (r, k, v))
    w = lay(w, 1.0)
    loc, dec = [], []
    for g in range(nseg - 1):
        st = torch.zeros(bsz, h, n, n)
        d = torch.ones(bsz, h, n)
        for b0 in range(g * seg, (g + 1) * seg, WKV_SUB):
            sl = slice(b0, b0 + WKV_SUB)
            kq, q = _suffix(k[:, :, sl], w[:, :, sl])
            hi, lo = _split(kq)
            vt = v[:, :, sl].transpose(-1, -2)
            st = st * q[:, :, None, :] + vt @ hi + vt @ lo
            d = d * q
        loc.append(st)
        dec.append(d)
    s_in = [torch.zeros(bsz, h, n, n)] + loc[:1]
    for g in range(1, nseg - 1):
        s_in.append(s_in[-1] * dec[g][:, :, None, :] + loc[g])
    y = torch.zeros(bsz, h, seg * nseg, n)
    ub = u.float()[None]
    for g in range(nseg):
        st = s_in[g]
        for b0 in range(g * seg, min((g + 1) * seg, s), WKV_SUB):
            sl = slice(b0, b0 + WKV_SUB)
            rr, kk, vv, ww = r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl]
            p = torch.ones(bsz, h, n)
            rp = torch.empty_like(rr)
            for t in range(WKV_SUB):
                rp[:, :, t] = rr[:, :, t] * p
                p = p * ww[:, :, t]
            kq, _ = _suffix(kk, ww)
            a = torch.zeros(bsz, h, WKV_SUB, WKV_SUB)
            for tau in range(WKV_SUB):
                a[:, :, tau, tau] = (rr[:, :, tau] * ub
                                     * kk[:, :, tau]).sum(-1)
                pp = torch.ones(bsz, h, n)
                for t in range(tau + 1, WKV_SUB):
                    a[:, :, t, tau] = (rr[:, :, t] * kk[:, :, tau]
                                       * pp).sum(-1)
                    pp = pp * ww[:, :, t]
            sh, sl_ = _split(st)
            rh, rl = _split(rp)
            yt = (sh @ rh.transpose(-1, -2) + sh @ rl.transpose(-1, -2)
                  + sl_ @ rh.transpose(-1, -2))
            ah, al = _split(a)
            vt = vv.transpose(-1, -2)
            yt = yt + vt @ ah.transpose(-1, -2) + vt @ al.transpose(-1, -2)
            y[:, :, sl] = yt.transpose(-1, -2)
            kh, kl = _split(kq)
            st = st * p[:, :, None, :] + vt @ kh + vt @ kl
    return (y[:, :, :s].permute(0, 2, 1, 3),
            st.transpose(-1, -2).contiguous())


def _inputs(rng, b, s, h=2, n=16):
    """r, k, v rounded to bf16 values (what the kernel reads); the decay
    as the model makes it (exp(-exp(.)) around a per-channel bias), with
    a few channels of a few tokens set to exactly 0, exactly 1 and e^-40;
    a nonzero bonus u."""
    bf = lambda a: np.asarray(torch.from_numpy(a.astype(np.float32))
                              .to(BF16).float())
    r, k, v = (bf(rng.standard_normal((b, s, h, n))) for _ in range(3))
    bias = np.linspace(-6.0, -0.5, n)
    w = np.exp(-np.exp(0.5 * rng.standard_normal((b, s, h, n)) + bias))
    w = w.astype(np.float32)
    for val in (0.0, 1.0, np.exp(-40.0)):
        hit = rng.random((b, s, h, n)) < 0.02
        w[hit] = np.float32(val)
    u = (0.5 * rng.standard_normal((h, n))).astype(np.float32)
    return r, k, v, w, u


def _rel_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("b,s,q", [(1, 1, 1), (2, 15, 5), (1, 16, 16),
                                   (2, 17, 17), (2, 37, 37), (1, 63, 21),
                                   (1, 64, 16), (2, 65, 13), (1, 128, 64),
                                   (1, 129, 43), (1, 999, 111),
                                   (1, 999, 999)])
def test_wkv_model_matches_pallas(b, s, q):
    """The model against the interpret-mode Pallas ``_wkv_kernel`` at the
    caller's chunk, y and the final state each on its own scale."""
    args = _inputs(np.random.default_rng(s * 10 + b), b, s)
    want_y, want_h = wkv6_pallas(*(jnp.asarray(a) for a in args), chunk=q,
                                 interpret=True)
    y, h = wkv_model(*(torch.from_numpy(a) for a in args))
    _rel_close(y.numpy(), want_y)
    _rel_close(h.numpy(), want_h)


def test_wkv_model_clamp_free():
    """Where the eager chunked form's clamp of the log decay at -5 would
    differ (every decay e^-40), the model still holds to the Pallas
    kernel: nothing in it divides or clamps."""
    rng = np.random.default_rng(7)
    r, k, v, w, u = _inputs(rng, 1, 80)
    w[:] = np.float32(np.exp(-40.0))
    w[:, ::7] = 1.0
    want_y, want_h = wkv6_pallas(*(jnp.asarray(a) for a in (r, k, v, w, u)),
                                 chunk=80, interpret=True)
    y, h = wkv_model(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    _rel_close(y.numpy(), want_y)
    _rel_close(h.numpy(), want_h)


def test_wkv_model_rows_do_not_depend_on_length_chunk_or_batch():
    """The model's y rows 0..S'-1 at S = 160 equal the S' = 100 and 64
    sequences' bit for bit; a sequence alone equals itself in a batch of
    2 (the model takes no chunk: nor does the kernel)."""
    args = [torch.from_numpy(a) for a in _inputs(np.random.default_rng(9),
                                                 2, 160)]
    full_y, _ = wkv_model(*(a[:1] for a in args[:4]), args[4])
    for cut in (100, 64):
        y, _ = wkv_model(*(a[:1, :cut] for a in args[:4]), args[4])
        assert torch.equal(y, full_y[:, :cut])
    pair_y, pair_h = wkv_model(*args)
    alone_y, alone_h = wkv_model(*(a[1:] for a in args[:4]), args[4])
    assert torch.equal(alone_y, pair_y[1:]) and torch.equal(alone_h,
                                                            pair_h[1:])
