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


def _emulate(x: torch.Tensor, desc, esz, per_warp, blocks):
    """What ``csrc/stream_converter.cu`` writes, step for step: each warp
    of ``blocks`` x 8 decodes its first token, then counts the radix up;
    16-byte vectors move a row only where every address is aligned."""
    n, row = desc.n_tokens, desc.row
    eh, ew, nl = desc.eh, desc.ew, desc.nloops
    trip = list(desc.trip)[:nl]
    flat = x.reshape(-1)
    out = torch.full((n, eh * ew), -1, dtype=x.dtype)
    for warp in range(blocks * 8):
        t = warp * per_warp
        t_end = min(t + per_warp, n)
        if t >= t_end:
            continue
        idx, rem = [0] * nl, t
        for k in reversed(range(nl)):
            idx[k], rem = rem % trip[k], rem // trip[k]
        for t in range(t, t_end):
            oh = sum(i * c for i, c in zip(idx, desc.ch))
            ow = sum(i * c for i, c in zip(idx, desc.cw))
            for r in range(eh):
                at = (oh + r) * row + ow
                if desc.vec:
                    assert (at * esz) % 16 == 0 and (ew * esz) % 16 == 0
                    assert ((t * eh * ew + r * ew) * esz) % 16 == 0
                out[t, r * ew:(r + 1) * ew] = flat[at:at + ew]
            for k in reversed(range(nl)):
                idx[k] += 1
                if idx[k] < trip[k]:
                    break
                idx[k] = 0
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
        _, _, desc, esz, per_warp, blocks, _ = hit.value.args
        assert esz == x.element_size()
        assert blocks * 8 * per_warp >= dst.num_tokens
        got = _emulate(x, desc, esz, per_warp, blocks)
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
    assert K.convert_layout.launches == 0
