"""K13 (``mamba2_ssd``) as a sequence-split scan on the tensor cores, on
the CPU.

Its CUDA code runs only on the card (``chip_smoke.py``'s ``tensorcore``
phase holds it there against the plain version, y and the final state
each on its own scale, and bit for bit across prompt lengths, chunks and
batches: ``tensorcore_ssd``; ``chip_phases.py ssd_hashes`` hashes the
float32 kernel's outputs against another tree's).  Here: ``ssd_plan``'s
segments, the route each dtype takes to its C entry point with the plan's
arguments and a workspace (a fake library stands in for the build), the
refusals, the profile's attribution of the new kernels, and a float32
model of the bf16 algorithm (64-row segments from position 0, each
segment's own end state, the pass across segments, the outputs, every
hi + lo bf16 split emulated) against the interpret-mode Pallas kernel at
S in {1, 37, 63, 64, 65, 128, 129, 999} with small H/P/N and several Q,
at relative 1e-5.
"""

import importlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.mamba2_scan import mamba2_ssd_pallas
from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.common import SSD_SEG, cdiv, ssd_plan

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


ssd_mod = importlib.import_module("repro_torch.kernels.mamba2_scan")
BF16, F32 = torch.bfloat16, torch.float32
REL = 1e-5


@pytest.mark.parametrize("s", [1, 2, 37, 63, 64, 65, 128, 129, 999, 1000,
                               2048, 4097])
def test_ssd_plan_covers_the_sequence_in_fixed_segments(s):
    """Segments of ``SSD_SEG`` rows from position 0 cover [0, S) once,
    the last one partial where SSD_SEG does not divide S; the segment
    length is the same at every S (a row's segment and its rows before it
    do not depend on the prompt's length)."""
    seg, nseg = ssd_plan(s)
    assert seg == SSD_SEG == 64
    assert nseg == cdiv(s, seg)
    starts = [k * seg for k in range(nseg)]
    rows = [min(seg, s - r0) for r0 in starts]
    assert all(r > 0 for r in rows) and sum(rows) == s
    assert rows[:-1] == [seg] * (nseg - 1)
    assert (rows[-1] < seg) == (s % seg != 0)


@pytest.fixture
def card_route(monkeypatch):
    """Force the CUDA route for CPU tensors, with every library a
    ``_FakeLib``; returns (recorded launches, recorded allocations)."""
    calls, allocs = [], []
    monkeypatch.setattr(ssd_mod, "kernel_path", lambda t: "cuda")
    ssd_mod._entry.cache_clear()
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(name, calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    empty = torch.empty

    def record(*shape, **kw):
        out = empty(*shape, **kw)
        allocs.append((tuple(out.shape), out.dtype, out.data_ptr()))
        return out

    monkeypatch.setattr(ssd_mod.torch, "empty", record)
    yield calls, allocs
    ssd_mod._entry.cache_clear()


def _args(dtype, b=1, s=37, h=3, p=64, n=64):
    gen = torch.Generator().manual_seed(s)
    x = torch.randn(b, s, h, p, generator=gen).to(dtype)
    dt = torch.rand(b, s, h, generator=gen).to(dtype)
    bc = [torch.randn(b, s, n, generator=gen).to(dtype) for _ in range(2)]
    return (x, dt, torch.zeros(h), bc[0], bc[1], torch.ones(h))


@pytest.mark.parametrize("b,s,chunk", [(1, 1, 128), (1, 37, 37),
                                       (1, 999, 1), (1, 999, 27),
                                       (1, 1000, 8), (2, 2048, 128),
                                       (2, 65, 5)])
def test_bf16_ssd_passes_the_plan_and_a_workspace(card_route, b, s, chunk):
    """bf16: ``repro_mamba2_ssd_seg_bf16`` with ``ssd_plan(S)``'s segment
    length and count whatever the chunk, and one float32 workspace of
    every segment's state and decay, allocated by the call (after the
    final state)."""
    calls, allocs = card_route
    before = K.mamba2_ssd.launches
    x, dt, a_log, bm, cm, d = _args(BF16, b, s)
    K.mamba2_ssd(x, dt, a_log, bm, cm, d, chunk=chunk)
    (lib, symbol, args), = calls
    assert (lib, symbol) == ("mamba2_scan", "repro_mamba2_ssd_seg_bf16")
    seg, nseg = ssd_plan(s)
    assert args[10:17] == (b, s, 3, 64, 64, seg, nseg)
    # a_log and d_skip as they are (float32 here: flag 0).
    assert (args[2], args[5], args[6]) == (a_log.data_ptr(), d.data_ptr(), 0)
    (hshape, hdt, hp), (wshape, wdt, wp) = allocs
    assert (hshape, hdt, args[8]) == ((b, 3, 64, 64), F32, hp)
    assert wdt == F32 and args[9] == wp
    assert wshape == (b * 3 * nseg * (64 * 64 + 1),)
    assert all(a % 16 == 0 for a in (args[0], args[3], args[4]))
    assert K.mamba2_ssd.launches == before + 1


@pytest.mark.parametrize("a_dt,d_dt,flag,converted", [
    (BF16, BF16, 1, False), (F32, F32, 0, False), (BF16, F32, 0, True)])
def test_bf16_ssd_reads_the_head_parameters_as_they_are(card_route, a_dt,
                                                       d_dt, flag, converted):
    """a_log and d_skip reach the kernels as they are, with a flag for
    bf16; only a pair of mixed dtypes is converted (to float32) first."""
    calls, _ = card_route
    x, dt, _, bm, cm, _ = _args(BF16, 1, 65)
    a_log, d = torch.zeros(3, dtype=a_dt), torch.ones(3, dtype=d_dt)
    K.mamba2_ssd(x, dt, a_log, bm, cm, d, chunk=13)
    (_, _, args), = calls
    assert args[6] == flag
    same = (args[2], args[5]) == (a_log.data_ptr(), d.data_ptr())
    assert same != converted


@pytest.mark.parametrize("chunk", [1, 8, 40, 125])
def test_f32_ssd_keeps_its_chunked_entry(card_route, chunk):
    """float32: the one-block-per-head kernel at the caller's chunk, no
    workspace."""
    calls, allocs = card_route
    K.mamba2_ssd(*_args(F32, 1, 1000, p=32, n=16), chunk=chunk)
    (lib, symbol, args), = calls
    assert (lib, symbol) == ("mamba2_scan", "repro_mamba2_ssd_f32")
    assert args[8:14] == (1, 1000, 3, 32, 16, chunk)
    assert [shape for shape, _, _ in allocs] == [(1, 3, 32, 16)]


@pytest.mark.parametrize("bad", ["P 32", "N 16", "chunk 7", "mixed dtypes"])
def test_ssd_refusals(card_route, bad):
    """bf16 takes zamba2's P = N = 64 alone; a chunk that does not divide
    S is refused in both dtypes, as the reference asserts; x, dt, B and C
    share a dtype.  Nothing launches."""
    calls, _ = card_route
    kw = {"P 32": dict(p=32), "N 16": dict(n=16)}.get(bad, {})
    x, dt, a_log, bm, cm, d = _args(BF16, 1, 24, **kw)
    if bad == "mixed dtypes":
        dt = dt.float()
    with pytest.raises((ValueError, TypeError)):
        K.mamba2_ssd(x, dt, a_log, bm, cm, d,
                     chunk=7 if bad == "chunk 7" else 8)
    assert calls == []


def test_profile_attributes_the_segment_kernels_to_k13():
    names = _global_functions()
    seg_names = {"ssd_seg_state_kernel", "ssd_seg_carry_kernel",
                 "ssd_seg_out_kernel"}
    assert seg_names | {"mamba2_ssd_kernel"} <= names
    stage = dict(_own_kernels())
    for name in seg_names | {"mamba2_ssd_kernel"}:
        hits = [k for k in stage if k in name]
        assert len(hits) == 1 and "K13" in stage[hits[0]], (name, hits)
    assert stage["ssd_seg_"] != stage["mamba2_ssd_kernel"]


# --------------------------------------------------------------------- #
# A float32 model of the sequence-split algorithm
# --------------------------------------------------------------------- #

def _split(t: torch.Tensor):
    """hi + lo bf16 planes of a float32 tensor, as float32."""
    hi = t.to(BF16).float()
    return hi, (t - hi).to(BF16).float()


def ssd_model(x, dt, a_log, b, c, d_skip):
    """The bf16 kernel's algorithm in float32 (inputs as float32 holding
    the bf16 values the kernel reads): per segment of ``ssd_plan``, rows
    at or past S zero (dt 0); its own end state x^T B' with B' = B o dt
    exp(cum_L - cum) split hi + lo, its decay exp(cum_L); the pass across
    segments h_k = h_{k-1} exp(cum_L) + S_{k-1}; then y = G' x (G' = (C
    B^T) o L o dt_j split) + exp(cum) (C h_k^T, h_k split) + x d."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    seg, nseg = ssd_plan(s)
    a = -torch.exp(a_log.float())
    tri = torch.tril(torch.ones(seg, seg, dtype=torch.bool))
    y = torch.zeros(bsz, s, h, p)
    final = torch.zeros(bsz, h, p, n)
    for bi in range(bsz):
        for hd in range(h):
            parts = []
            for k in range(nseg):
                r0 = k * seg
                rows = min(seg, s - r0)
                xs, bs, cs = (torch.zeros(seg, w) for w in (p, n, n))
                dts = torch.zeros(seg)
                xs[:rows] = x[bi, r0:r0 + rows, hd]
                bs[:rows], cs[:rows] = (t[bi, r0:r0 + rows]
                                        for t in (b, c))
                dts[:rows] = dt[bi, r0:r0 + rows, hd]
                cum = torch.cumsum(dts * a[hd], 0)
                bhi, blo = _split(bs * (dts * torch.exp(cum[-1] - cum))
                                  [:, None])
                parts.append(dict(r0=r0, rows=rows, xs=xs, bs=bs, cs=cs,
                                  dts=dts, cum=cum,
                                  state=xs.T @ bhi + xs.T @ blo,
                                  decay=torch.exp(cum[-1])))
            hk = torch.zeros(p, n)
            for part in parts:
                part["h"] = hk
                hk = hk * part["decay"] + part["state"]
            final[bi, hd] = hk
            for part in parts:
                cum, dts, xs, cs = (part[k] for k in ("cum", "dts", "xs",
                                                      "cs"))
                diff = torch.where(tri, cum[:, None] - cum[None, :], 0.0)
                g = torch.where(tri, (cs @ part["bs"].T) * torch.exp(diff)
                                * dts[None, :], 0.0)
                ghi, glo = _split(g)
                hhi, hlo = _split(part["h"])
                yk = (ghi @ xs + glo @ xs
                      + torch.exp(cum)[:, None] * (cs @ hhi.T + cs @ hlo.T)
                      + xs * d_skip[hd])
                rows, r0 = part["rows"], part["r0"]
                y[bi, r0:r0 + rows, hd] = yk[:rows]
    return y, final


def _inputs(rng, b, s, h=2, p=16, n=16):
    """x, dt (softplus-ed, small), a_log (the init's), B, C, d_skip, with
    x, dt, B and C rounded to bf16 values (what the kernel reads)."""
    bf = lambda a: np.asarray(torch.from_numpy(a.astype(np.float32))
                              .to(BF16).float())
    x = bf(rng.standard_normal((b, s, h, p)))
    dt = bf(0.1 * np.log1p(np.exp(rng.standard_normal((b, s, h)))))
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    bm, cm = (bf(rng.standard_normal((b, s, n))) for _ in range(2))
    return x, dt, a_log, bm, cm, rng.standard_normal(h).astype(np.float32)


def _rel_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("b,s,q", [(1, 1, 1), (2, 37, 37), (1, 63, 21),
                                   (1, 64, 16), (2, 65, 13), (1, 128, 64),
                                   (1, 129, 43), (1, 999, 111)])
def test_ssd_model_matches_pallas(b, s, q):
    """The model against the interpret-mode Pallas ``_ssd_kernel`` at the
    caller's chunk Q, y and the final state each on its own scale."""
    args = _inputs(np.random.default_rng(s * 10 + b), b, s)
    want_y, want_h = mamba2_ssd_pallas(*(jnp.asarray(a) for a in args),
                                       chunk=q, interpret=True)
    y, h = ssd_model(*(torch.from_numpy(a) for a in args))
    _rel_close(y.numpy(), want_y)
    _rel_close(h.numpy(), want_h)
