"""The port's itensor types, Algorithm 1 and the layout converter K15 on
the CPU, against the JAX package.

* ``infer_converter``, ``shared_prefix_length``, ``fusion_verdict``,
  ``min_buffer_tiles_sim`` and ``conversion_cost_bytes`` equal the
  reference's on the paper's Fig. 5 pair, the cases of
  ``tests/test_converter.py`` and a seeded sweep of 200 random
  ``itensor_from_tiling`` pairs (ranks 1-3, tiles, loop orders, reuse
  loops, dtypes), errors included.
* K15's plain version (``convert_layout`` on a CPU tensor) equals, bit for
  bit, the reference's interpret-mode Pallas ``convert_layout`` and its
  ``convert_layout_ref`` on the same numpy data: row-to-column pairs, the
  identity FIFO, a partial shared prefix, Fig. 5, a consumer reuse loop
  and a non-exact tiling, in float32, bfloat16 and int8.  Its offsets
  equal ``stream_offsets``; chunking does not change it.
* The wrapper refuses a wrong data shape, a dtype or data-space mismatch
  and a device that is neither CPU nor CUDA.  On the card route (forced
  for CPU tensors, stopped at the launch) it refuses what the CUDA kernel
  does not take, and a Python model of the kernel's indexing, run from the
  descriptor and launch geometry the wrapper hands over, gives the plain
  version's stream, with 16-byte vectors only where every address is
  aligned.
"""

import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import converter as JC
from repro.core import itensor as JI
from repro.kernels import convert_layout as j_convert_layout
from repro.kernels import ref as j_ref
from repro_torch import kernels as K
from repro_torch.core import converter as C
from repro_torch.core import itensor as I
from repro_torch.kernels import _build, ref
from repro_torch.kernels import stream_converter as sc_mod


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FUNCS = ("infer_converter", "shared_prefix_length", "fusion_verdict",
         "min_buffer_tiles_sim", "conversion_cost_bytes")


def _norm(x):
    """A dataclass as (class name, fields), recursively: the two packages'
    records compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _norm(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    return x


def _to_ref(t):
    """The reference's ``ITensorType`` with the fields of the port's."""
    return JI.ITensorType(t.elem_shape, t.tripcounts, t.steps,
                          JI.AffineMap(t.iter_map.num_dims,
                                       t.iter_map.results), t.dtype)


def _outcome(fn, *args):
    try:
        return ("ok", _norm(fn(*args)))
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__,)


def _assert_same_analysis(src, dst):
    """Every Algorithm-1 query of the port equals the reference's."""
    jsrc, jdst = _to_ref(src), _to_ref(dst)
    assert _norm(jsrc) == _norm(src) and _norm(jdst) == _norm(dst)
    for name in FUNCS:
        mine = _outcome(getattr(C, name), src, dst)
        want = _outcome(getattr(JC, name), jsrc, jdst)
        assert mine == want, (name, str(src), str(dst))


# ------------------------------------------------------- Algorithm 1

def _analysis_cases():
    b, c = I.fig5_b(), I.fig5_c()
    return {
        "fig5_b_to_c": (b, c),
        "fig5_c_to_b": (c, b),
        "fig5_identity": (b, b),
        "canonical_reuse_1": (I.row_major((8, 8), (4, 2)),
                              I.itensor_from_tiling((8, 8), (4, 2),
                                                    reuse=[(0, 1)])),
        "row_to_col_64": (I.row_major((64, 64), (16, 16)),
                          I.col_major((64, 64), (16, 16))),
        "row_to_col_8": (I.row_major((8, 8), (2, 2)),
                         I.col_major((8, 8), (2, 2))),
        "dtype_mismatch": (I.row_major((8, 8), (4, 2)),
                           I.row_major((8, 8), (4, 2), dtype="bfloat16")),
        "data_space_mismatch": (I.row_major((8, 8), (4, 2)),
                                I.row_major((16, 8), (4, 2))),
        "retile": (I.row_major((16, 16), (4, 4)),
                   I.row_major((16, 16), (8, 2))),
    }


@pytest.mark.parametrize("case", sorted(_analysis_cases()))
def test_algorithm1_matches_reference(case):
    _assert_same_analysis(*_analysis_cases()[case])


def test_fig5_worked_example():
    spec = C.infer_converter(I.fig5_b(), I.fig5_c())
    assert (spec.buf_shape, spec.shared_prefix_len, spec.reuse_count) == \
        ((8, 2), 1, 4)
    assert spec.window_tiles((4, 2)) == 2
    assert spec.pingpong_bytes == 2 * 8 * 2 * 4
    assert C.min_buffer_tiles_sim(I.fig5_b(), I.fig5_c()) == 2
    assert C.fusion_verdict(I.fig5_b(), I.fig5_c()) == "converter"


def _random_type(rng, data, tiles, dtype):
    rank = len(data)
    order = [int(v) for v in rng.permutation(rank)]
    reuse = None
    if rng.random() < 0.4:
        reuse = [(int(rng.integers(0, rank + 1)), int(rng.integers(1, 4)))]
    return I.itensor_from_tiling(data, tiles, loop_order=order, reuse=reuse,
                                 dtype=dtype)


def test_random_pairs_match_reference():
    """200 seeded pairs: shared data shapes, the same or other tiles, any
    loop orders, reuse loops, now and then another dtype or shape."""
    rng = np.random.default_rng(19)
    verdicts = set()
    for _ in range(200):
        rank = int(rng.integers(1, 4))
        tiles = [int(rng.choice([1, 2, 4])) for _ in range(rank)]
        data = [t * int(rng.integers(1, 5)) for t in tiles]
        other = list(tiles)
        if rng.random() < 0.2:
            j = int(rng.integers(0, rank))
            other[j] = int(rng.choice([d for d in (1, 2, 4)
                                       if data[j] % d == 0]))
        dtype = "float32" if rng.random() < 0.9 else "bfloat16"
        src = _random_type(rng, data, tiles, "float32")
        dst_data = list(data)
        if rng.random() < 0.05:
            dst_data[0] *= 2
        dst = _random_type(rng, dst_data, other, dtype)
        _assert_same_analysis(src, dst)
        verdicts.add(_outcome(C.fusion_verdict, src, dst))
    assert {("ok", v) for v in ("match", "converter", "rebuffer",
                                "incompatible")} <= verdicts


# ---------------------------------------------- K15's plain version

def _layout_cases():
    fsrc = I.itensor_from_tiling((32, 16), (4, 4), loop_order=(0, 1))
    fdst = I.itensor_from_tiling((32, 16), (4, 4), loop_order=(1, 0))
    # Tiles narrower than the steps of their loops (not an exact tiling).
    gap = I.ITensorType((2, 3), (4, 2), (4, 8), I.AffineMap(2, (0, 1)))
    gap_t = I.ITensorType((2, 3), (2, 4), (8, 4), I.AffineMap(2, (1, 0)))
    return {
        "row_to_col_32_8": (I.row_major((32, 32), (8, 8)),
                            I.col_major((32, 32), (8, 8))),
        "row_to_col_64x32_16x8": (I.row_major((64, 32), (16, 8)),
                                  I.col_major((64, 32), (16, 8))),
        "identity_fifo": (I.row_major((32, 32), (8, 8)),) * 2,
        "partial_shared_prefix": (fsrc, fdst),
        "fig5_b_to_c": (I.fig5_b(), I.fig5_c()),
        "consumer_reuse": (I.row_major((16, 24), (4, 8)),
                           I.itensor_from_tiling((16, 24), (4, 8),
                                                 loop_order=(1, 0),
                                                 reuse=[(1, 3)])),
        "non_exact_tiling": (gap, gap_t),
    }


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _data(shape, dname, seed=0):
    rng = np.random.default_rng(seed)
    if dname == "int8":
        return rng.integers(-128, 128, size=shape).astype(np.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    if dname == "bfloat16":   # values a bf16 holds exactly, on both sides
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


def _as_numpy(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _j_numpy(x):
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.mark.parametrize("dname", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(_layout_cases()))
def test_convert_layout_matches_pallas_bit_for_bit(case, dname):
    src, dst = _layout_cases()[case]
    x = _data(src.data_shape, dname)
    jdt, tdt = DTYPES[dname]
    before = K.convert_layout.launches
    got = K.convert_layout(torch.from_numpy(x).to(tdt), src, dst)
    assert K.convert_layout.launches == before
    assert got.dtype == tdt and tuple(got.shape) == \
        (dst.num_tokens, *dst.elem_shape)
    jsrc, jdst = _to_ref(src), _to_ref(dst)
    jx = jnp.asarray(x).astype(jdt)
    pallas = _j_numpy(j_convert_layout(jx, jsrc, jdst, interpret=True))
    oracle = _j_numpy(j_ref.convert_layout_ref(jx, jsrc, jdst))
    mine = _as_numpy(got)
    np.testing.assert_array_equal(mine, pallas)
    np.testing.assert_array_equal(mine, oracle)
    assert mine.tobytes() == pallas.astype(mine.dtype).tobytes()


@pytest.mark.parametrize("case", sorted(_layout_cases()))
def test_token_offsets_equal_stream_offsets(case, monkeypatch):
    _, dst = _layout_cases()[case]
    oh, ow = ref.stream_token_offsets(dst, torch.arange(dst.num_tokens))
    assert list(zip(oh.tolist(), ow.tolist())) == list(dst.stream_offsets())
    # Chunking the gather changes nothing.
    x = torch.from_numpy(_data(dst.data_shape, "float32", seed=3))
    whole = ref.convert_layout_ref(x, dst, dst)
    monkeypatch.setattr(ref, "CONVERT_CHUNK", 5)
    assert torch.equal(ref.convert_layout_ref(x, dst, dst), whole)


def test_convert_layout_refuses_bad_input():
    src, dst = I.row_major((16, 16), (4, 4)), I.col_major((16, 16), (4, 4))
    x = torch.zeros(16, 16)
    with pytest.raises(ValueError, match="!="):
        K.convert_layout(torch.zeros(16, 12), src, dst)
    with pytest.raises(ValueError, match="dtype mismatch"):
        K.convert_layout(x, src, I.col_major((16, 16), (4, 4), "bfloat16"))
    with pytest.raises(ValueError, match="data space mismatch"):
        K.convert_layout(x, src, I.col_major((32, 16), (4, 4)))
    with pytest.raises(ValueError, match="unsupported device"):
        K.convert_layout(x.to("meta"), src, dst)
    assert K.convert_layout.launches == 0


# ------------------------------------------------------ the card route

class _Launched(Exception):
    """Raised in place of a kernel launch, carrying its arguments."""


NT, U = 256, 4   # csrc/stream_converter.cu: threads per block, vectors
                 # in flight per thread


def _token_offsets(desc, tokens):
    """``token_offset`` of the kernel: each token's data offset oh W + ow
    (int64 here; the kernel's int32 is checked to hold it)."""
    oh = np.zeros(len(tokens), np.int64)
    ow = np.zeros(len(tokens), np.int64)
    rem = np.asarray(tokens, np.int64)
    for k in reversed(range(desc.nloops)):
        i, rem = rem % desc.trip[k], rem // desc.trip[k]
        oh += i * desc.ch[k]
        ow += i * desc.cw[k]
    return oh * desc.row + ow


def _step(tok, r, c, dt, dr, dc, rows, cols):
    c = c + dc
    r = r + dr
    wrap = c >= cols
    c, r = np.where(wrap, c - cols, c), np.where(wrap, r + 1, r)
    wrap = r >= rows
    r, tok = np.where(wrap, r - rows, r), np.where(wrap, tok + 1, tok)
    return tok + dt, r, c


def _emulate_block(desc, esz, b, numel):
    """What block ``b`` of ``csrc/stream_converter.cu`` writes, step for
    step, vectorized over its 256 threads: (e0, the flat data index of
    each element of its range [e0, e0 + elems)).  Asserts what the kernel
    relies on: at most ``MAX_TOKENS`` tokens decoded, every token read
    among them, 32-bit offsets inside the data, 16-byte aligned loads on
    the vector path and 16-byte aligned stores."""
    vl = 16 // esz
    b0 = b * desc.run
    nbytes = min(desc.run, desc.total - b0)
    assert b0 % 16 == 0 and nbytes > 0
    tile = desc.eh * desc.ew
    e0 = b0 // esz
    t0 = e0 // tile
    rel0 = e0 - t0 * tile
    elems = nbytes // esz
    ntok = (rel0 + elems - 1) // tile + 1
    assert ntok <= sc_mod.MAX_TOKENS
    toff = _token_offsets(desc, t0 + np.arange(ntok))
    assert toff.max() < 2 ** 31
    got = np.full(elems, -1, np.int64)
    tid = np.arange(NT)
    nvec = nbytes // 16
    ix = np.arange(vl)
    if desc.vec:
        vpr = desc.ew // vl
        vpt = desc.eh * vpr
        q = rel0 // vl + tid
        tok, p = np.divmod(q, vpt)
        r, c = np.divmod(p, vpr)
        dt, dp = divmod(NT, vpt)
        dr, dc = divmod(dp, vpr)
        for v0 in range(0, nvec, NT):
            v = v0 + tid
            live = v < nvec
            src = (toff[tok[live]] + r[live] * desc.row + c[live] * vl)
            assert (src * esz % 16 == 0).all()
            got[(v[live] * vl)[:, None] + ix] = src[:, None] + ix
            tok, r, c = _step(tok, r, c, dt, dr, dc, desc.eh, vpr)
    else:
        # A warp's chunk of 32 vl elements: lane l loads elements l, l +
        # 32, ...; the chunk leaves as 32 vectors (the order of the warps
        # over the chunks does not change what is written).
        dt, dp = divmod(32, tile)
        dr, dc = divmod(dp, desc.ew)
        lane = np.arange(32)
        for ch in range(-(-elems // (32 * vl))):
            e = ch * 32 * vl + lane
            tok, p = np.divmod(rel0 + e, tile)
            r, c = np.divmod(p, desc.ew)
            for j in range(vl):
                ee = e + 32 * j
                live = ee < elems
                got[ee[live]] = (toff[tok[live]] + r[live] * desc.row
                                 + c[live])
                tok, r, c = _step(tok, r, c, dt, dr, dc, desc.eh, desc.ew)
    assert (got >= 0).all() and got.max() < numel
    return e0, got


def _emulate(x: torch.Tensor, desc, esz, blocks):
    """The whole stream the kernel writes, block by block."""
    n, eh, ew = desc.n_tokens, desc.eh, desc.ew
    assert (blocks - 1) * desc.run < desc.total <= blocks * desc.run
    flat = x.reshape(-1)
    out = torch.full((n * eh * ew,), -1, dtype=x.dtype)
    for b in range(blocks):
        e0, idx = _emulate_block(desc, esz, b, x.numel())
        out[e0:e0 + len(idx)] = flat[torch.from_numpy(idx)]
    return out.reshape(n, eh, ew)


@pytest.fixture
def card_route(monkeypatch):
    """Force the kernel route for CPU tensors; the C entry point raises
    ``_Launched`` with its arguments."""
    monkeypatch.setattr(sc_mod, "kernel_path", lambda t: "cuda")

    def launch(*args):
        raise _Launched(*args)

    monkeypatch.setattr(sc_mod, "_entry", lambda: launch)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(
        f"reached the build of {name}"))

    def sms(count):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: types.SimpleNamespace(
                                multi_processor_count=count))
    return sms


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("case", sorted(_layout_cases()))
def test_kernel_indexing_model_gives_the_plain_stream(card_route, case, sms):
    card_route(sms)
    src, dst = _layout_cases()[case]
    for dname in DTYPES:
        x = torch.from_numpy(_data(src.data_shape, dname)).to(
            DTYPES[dname][1])
        with pytest.raises(_Launched) as hit:
            K.convert_layout(x, src, dst)
        _, _, desc, esz, blocks, _ = hit.value.args
        assert esz == x.element_size()
        assert desc.run % 16 == 0 and desc.total == (
            dst.num_tokens * dst.elem_shape[0] * dst.elem_shape[1] * esz)
        got = _emulate(x, desc, esz, blocks)
        assert torch.equal(got, ref.convert_layout_ref(x, src, dst))
    assert K.convert_layout.launches == 0


def test_card_route_vectors_only_on_aligned_rows(card_route):
    card_route(132)

    def vec(x, t):
        with pytest.raises(_Launched) as hit:
            K.convert_layout(x, t, t)
        return hit.value.args[2].vec

    def zeros(shape, tile, dtype):
        return torch.zeros(shape, dtype=dtype), I.row_major(shape, tile)
    assert vec(*zeros((32, 64), (16, 16), torch.bfloat16)) == 1   # 32 B rows
    assert vec(*zeros((32, 64), (16, 8), torch.bfloat16)) == 1    # 16 B rows
    assert vec(*zeros((32, 60), (16, 10), torch.bfloat16)) == 0   # 20 B rows
    assert vec(*zeros((32, 64), (16, 4), torch.float32)) == 1
    assert vec(*zeros((32, 64), (16, 16), torch.int8)) == 1
    assert vec(*zeros((32, 64), (16, 8), torch.int8)) == 0
    # 16-byte rows 24 bytes apart: the column step is not aligned.
    gap = I.ITensorType((2, 8), (4, 2), (4, 12), I.AffineMap(2, (0, 1)))
    assert vec(torch.zeros(16, 24, dtype=torch.bfloat16), gap) == 0
    # Aligned rows in a tensor that starts 4 bytes past a boundary.
    t = I.row_major((8, 8), (4, 4))
    assert vec(torch.zeros(8, 8), t) == 1
    assert vec(torch.zeros(65)[1:].view(8, 8), t) == 0


def test_card_route_refuses_what_the_kernel_lacks(card_route):
    card_route(132)
    t = I.row_major((8, 8), (4, 4))
    with pytest.raises(TypeError, match="1, 2 or 4 bytes"):
        K.convert_layout(torch.zeros(8, 8, dtype=torch.float64), t, t)
    with pytest.raises(ValueError, match="not contiguous"):
        K.convert_layout(torch.zeros(8, 16)[:, ::2], t, t)
    deep = I.itensor_from_tiling((8, 8), (4, 4),
                                 reuse=[(0, 2)] * 7)
    assert deep.iter_rank == 9
    with pytest.raises(ValueError, match="at most 8"):
        K.convert_layout(torch.zeros(8, 8), deep, deep)
    # 2^34 tokens: past the kernel's 31-bit token count.
    huge = I.itensor_from_tiling((8, 8), (4, 4), reuse=[(0, 1 << 16)] * 2)
    with pytest.raises(ValueError, match="31 bits"):
        K.convert_layout(torch.zeros(8, 8), huge, huge)
    assert K.convert_layout.launches == 0


# The compiled blocks' edges at full width: every distinct (src, dst)
# type pair of each family at 128 tokens, and llama3-8b's at 1000 tokens
# (streams up to 7.34 GB, windows up to [10, 14336]: 287 KB in bf16).
COMPILED = [("llama3-8b", 128), ("gpt2", 128), ("granite-moe-3b-a800m", 128),
            ("zamba2-2.7b", 128), ("rwkv6-7b", 128), ("llama3-8b", 1000)]


@functools.lru_cache(maxsize=None)
def _compiled_edges(arch, tokens):
    from repro_torch.configs import get_config
    from repro_torch.core import compile_model
    c = compile_model(get_config(arch), tokens=tokens)
    pairs = {}
    for _, _, _, d in c.graph.edges():
        pairs.setdefault((str(d["src_type"]), str(d["dst_type"])),
                         (d["src_type"], d["dst_type"]))
    return list(pairs.values())


def _want_indices(dst, row, e0, n_elems):
    """The plain stream's flat data index of elements [e0, e0 + n) (the
    gather ``ref.convert_layout_ref`` makes, as indices)."""
    eh, ew = dst.elem_shape
    tile = eh * ew
    t0, t1 = e0 // tile, (e0 + n_elems - 1) // tile + 1
    oh, ow = ref.stream_token_offsets(dst, torch.arange(t0, t1))
    idx = ((oh[:, None, None] + torch.arange(eh)[None, :, None]) * row
           + ow[:, None, None] + torch.arange(ew)[None, None, :])
    start = e0 - t0 * tile
    return idx.reshape(-1)[start:start + n_elems].numpy()


@pytest.mark.parametrize("arch,tokens", COMPILED)
def test_kernel_indexing_model_on_compiled_edges(arch, tokens):
    """On every compiled edge type, in bf16, float32 and int8, the blocks
    of the launch ``_plan`` makes (the first two, the last, the middle and
    eight seeded ones) read exactly the plain stream's data elements at
    their ranges; 16-byte loads only where every address aligns, so
    granite's 10-wide router and expert streams take the gather path."""
    rng = np.random.default_rng(tokens)
    paths = set()
    for src, dst in _compiled_edges(arch, tokens):
        for tdt in (torch.bfloat16, torch.float32, torch.int8):
            data = torch.empty(src.data_shape, dtype=tdt)
            desc, blocks = sc_mod._plan(data, dst, 132)
            esz = data.element_size()
            assert (blocks - 1) * desc.run < desc.total <= blocks * desc.run
            paths.add(desc.vec)
            ew = dst.elem_shape[1]
            assert desc.vec == int((ew * esz) % 16 == 0
                                   and (dst.steps[dst.iter_map.results[1]]
                                        * esz) % 16 == 0
                                   and (data.shape[1] * esz) % 16 == 0)
            picks = {0, min(1, blocks - 1), blocks - 1, blocks // 2,
                     *rng.integers(0, blocks, 8).tolist()}
            for b in sorted(picks):
                e0, got = _emulate_block(desc, esz, b, data.numel())
                np.testing.assert_array_equal(
                    got, _want_indices(dst, data.shape[1], e0, len(got)))
    assert 1 in paths
    if arch.startswith("granite"):
        assert 0 in paths


def test_kernel_model_unaligned_router_stream_bit_for_bit(card_route):
    """granite-3b's router stream (32 tokens of [16, 10], 20-byte rows)
    and its top-k stream into the experts (10-wide tiles at a column step
    of 10) through the card route: the gathered 16-byte vectors and the
    ragged tail give the plain stream bit for bit, in bf16 and float32."""
    card_route(132)
    edges = [(s, d) for s, d in _compiled_edges("granite-moe-3b-a800m", 128)
             if d.elem_shape == (16, 10)]
    assert {d.num_tokens for _, d in edges} >= {32}
    for src, dst in sorted(edges, key=lambda e: e[1].num_tokens)[:1]:
        for dname in ("bfloat16", "float32"):
            x = torch.from_numpy(_data(src.data_shape, dname)).to(
                DTYPES[dname][1])
            with pytest.raises(_Launched) as hit:
                K.convert_layout(x, src, dst)
            _, _, desc, esz, blocks, _ = hit.value.args
            assert desc.vec == 0
            got = _emulate(x, desc, esz, blocks)
            assert torch.equal(got, ref.convert_layout_ref(x, src, dst))
