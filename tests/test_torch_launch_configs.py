"""The launch layer's foundations on the CPU, against the JAX package: the
dry-run's cell matrix and the paper's models (``configs``), the roofline
on the H100's constants, the ``torch.distributed`` meshes, and the
single-device step functions with their abstract inputs
(``distributed.steps``).

* the four shape cells, ``ASSIGNED_ARCHS``, ``cells()``,
  ``skipped_cells()`` and ``PAPER_MODELS`` equal the reference's field
  for field; parameter counts and ``model_flops`` equal exactly for every
  registry config and paper model x every shape;
* ``roofline_from_counts`` is the reference's formula with the H100's
  peaks (the reference module patched to them), at the step's dtype;
  ``chip_smoke.bound`` is the roofline's, on the parent's constants;
* a one-process ``gloo`` world on a ``FileStore``: the host mesh, and the
  reference's ``ValueError`` for a mesh larger than the world; without a
  card and without ``device="cpu"`` every mesh function raises;
* the abstract inputs have the reference's keys, shapes and dtypes, the
  parameter and cache bytes the reference's leaf bytes; ``trace_cell``'s
  perf mode is the reference's config replacement and the pin modes
  raise; ``make_prefill_step`` and ``make_decode_step`` on bridged float32
  weights give the reference steps' logits, tokens and cache (1e-5).
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import ARCHS as J_ARCHS
from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import PAPER_MODELS as J_PAPER
from repro.configs import cells as j_cells
from repro.configs import get_config as j_get_config
from repro.configs import skipped_cells as j_skipped_cells
from repro.configs.base import ALL_SHAPES as J_SHAPES
from repro.configs.base import ShapeConfig as JShape
from repro.distributed import steps as j_steps
from repro.launch import roofline as j_roofline
from repro.launch.mesh import make_host_mesh as j_make_host_mesh
from repro.models import abstract_cache as j_abstract_cache
from repro.models import abstract_params as j_abstract_params
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro_torch.configs import (ALL_SHAPES, ARCHS, ASSIGNED_ARCHS,
                                 PAPER_MODELS, cells, get_config, get_shape,
                                 skipped_cells)
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.platforms import H100
from repro_torch.distributed import steps
from repro_torch.launch import mesh, roofline
from repro_torch.launch.op_analysis import storage_bytes
from repro_torch.models import (abstract_cache, abstract_params, init_cache,
                                init_params, params_from_numpy, prefill)

REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small CPU ops: one intra-op thread (restored after the
    module), so that test workers beside one another do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #

def test_shape_cells_equal_reference():
    assert list(ALL_SHAPES) == list(J_SHAPES)
    for name, shape in ALL_SHAPES.items():
        assert _fields(shape) == _fields(J_SHAPES[name])
        assert get_shape(name) is shape


def test_cells_and_skips_equal_reference():
    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert set(ARCHS) == set(J_ARCHS)
    got = [(_fields(c), _fields(s)) for c, s in cells()]
    want = [(_fields(c), _fields(s)) for c, s in j_cells()]
    assert got == want
    assert list(skipped_cells()) == list(j_skipped_cells())
    assert len(got) == 32


def test_paper_models_equal_reference():
    assert list(PAPER_MODELS) == list(J_PAPER)
    for name, cfg in PAPER_MODELS.items():
        assert _fields(cfg) == _fields(J_PAPER[name])


@pytest.mark.parametrize("arch", sorted(ARCHS) + sorted(PAPER_MODELS))
def test_model_flops_equal_reference(arch):
    cfg = ARCHS.get(arch) or PAPER_MODELS[arch]
    jcfg = J_ARCHS.get(arch) or J_PAPER[arch]
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for name, shape in ALL_SHAPES.items():
        assert roofline.model_flops(cfg, shape) == \
            j_roofline.model_flops(jcfg, J_SHAPES[name])


# --------------------------------------------------------------------- #
# roofline
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_roofline_is_the_reference_formula_on_h100(monkeypatch, dtype):
    cfg = dataclasses.replace(get_config("llama3-8b"), dtype=dtype)
    jcfg = dataclasses.replace(j_get_config("llama3-8b"), dtype=dtype)
    monkeypatch.setattr(j_roofline, "PEAK_FLOPS", roofline.PEAK_FLOPS[dtype])
    monkeypatch.setattr(j_roofline, "HBM_BW", H100.hbm_bw)
    monkeypatch.setattr(j_roofline, "LINK_BW", H100.link_bw)
    for name, shape in ALL_SHAPES.items():
        for flops, nbytes, coll in ((3.1e15, 2.2e12, 0.0),
                                    (1e9, 7.5e12, 4e9)):
            rec = {"cost": {"flops": flops, "bytes_accessed": nbytes},
                   "collectives": {"total": coll}}
            got = roofline.roofline_from_counts(cfg, shape, rec, chips=1)
            want = j_roofline.roofline_from_compiled(
                jcfg, J_SHAPES[name], rec, chips=1)
            assert got == want


def test_card_peaks_have_one_home():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert roofline.PEAK_INT8_OPS == 1979e12
    assert chip_smoke.bound is roofline.bound
    assert chip_smoke.HBM_BYTES_PER_S is roofline.HBM_BYTES_PER_S
    assert chip_smoke.PEAK_FLOPS is roofline.PEAK_FLOPS
    # The parent's formula: bytes at 3.35 TB/s or operations at the peak.
    assert roofline.bound(3.35e9, 1.0, "bfloat16") == (1.0, "bytes")
    assert roofline.bound(1.0, 67e9, "float32") == (1.0, "operations")


# --------------------------------------------------------------------- #
# meshes
# --------------------------------------------------------------------- #

def test_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_host_mesh(1, 1, device="cpu")


def test_one_process_gloo_mesh(tmp_path):
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        m = mesh.make_host_mesh(1, 1, device="cpu")
        assert tuple(m.shape) == (1, 1)
        assert m.mesh_dim_names == ("data", "model")
        assert m.device_type == "cpu"
        assert tuple(mesh.make_mesh((1,), ("data",),
                                    device="cpu").shape) == (1,)
        with pytest.raises(ValueError,
                           match="mesh 2x1 needs 2 devices, have 1"):
            mesh.make_host_mesh(2, 1, device="cpu")
        with pytest.raises(ValueError, match="needs 256 devices, have 1"):
            mesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="needs 512 devices, have 1"):
            mesh.make_production_mesh(multi_pod=True, device="cpu")
    finally:
        dist.destroy_process_group()


def test_mesh_without_a_card_raises(tmp_path, monkeypatch):
    """``device=None`` means the card: without one, every mesh function
    raises inside a running world instead of building a CPU mesh."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        for build in (lambda: mesh.make_host_mesh(1, 1),
                      lambda: mesh.make_mesh((1,), ("data",)),
                      lambda: mesh.make_production_mesh()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# steps: abstract inputs, perf mode, prefill and decode
# --------------------------------------------------------------------- #

def _leaf_bytes(tree) -> int:
    return sum(math.prod(a.shape) * np.dtype(a.dtype).itemsize
               for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_inputs_equal_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert storage_bytes(abstract_params(cfg)) == \
        _leaf_bytes(j_abstract_params(jcfg))
    for name in ALL_SHAPES:
        shape, jshape = ALL_SHAPES[name], J_SHAPES[name]
        got = steps.input_specs(cfg, shape)
        want = j_steps.input_specs(jcfg, jshape)
        assert set(got) == set(want)
        for key, t in got.items():
            if key == "cache":
                continue
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[key].shape), key
            assert str(t.dtype).removeprefix("torch.") == \
                str(want[key].dtype), key
        if shape.kind == "decode":
            assert storage_bytes(got["cache"]) == \
                _leaf_bytes(want["cache"])
    small = (4, 300)
    assert storage_bytes(abstract_cache(cfg, *small)) == \
        _leaf_bytes(j_abstract_cache(jcfg, *small))


def test_trace_cell_perf_and_pin_modes():
    cfg = get_config("rwkv6-7b")
    perf = steps.perf_config(cfg, "all")
    assert (perf.rwkv_chunk, perf.remat_attn_chunk,
            perf.kv_cache_layout) == (16, True, "bhsd")
    assert steps.perf_config(cfg, False) is cfg
    for mode in ("embed", "sp"):
        with pytest.raises(NotImplementedError, match="queue 1 item 10"):
            steps.trace_cell(cfg, get_shape("train_4k"), mode,
                             device="cpu")
    fn, (params, opt, batch) = steps.trace_cell(cfg, get_shape("train_4k"),
                                                True, device="cpu")
    assert set(batch) == {"tokens", "labels"}
    assert opt.step.dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            steps.trace_cell(cfg, get_shape("train_4k"))


def _bridged(arch, **kw):
    jcfg = dataclasses.replace(j_get_config(arch).reduced(),
                               dtype="float32", **kw)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **kw)
    jp = j_init_params(jax.random.PRNGKey(7), jcfg)
    return jcfg, cfg, jp, params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, device="cpu", dtype=torch.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-2.7b"])
def test_prefill_and_decode_steps_equal_reference(arch):
    jcfg, cfg, jp, tp = _bridged(arch)
    jmesh = j_make_host_mesh(1, 1)
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, cfg.vocab_size, (2, 24)).astype(np.int32)
    jfn, _, _ = j_steps.make_prefill_step(jcfg, jmesh)
    jlogits, _ = jfn(jp, {"tokens": tokens})
    fn = steps.make_prefill_step(cfg, device="cpu")
    logits, cache = fn(tp, {"tokens": tokens, "labels": tokens})
    assert _rel(logits.numpy(), jlogits) <= REL
    assert set(cache) >= ({"k", "v"} if arch == "llama3-8b" else {"ssm"})

    shape = ShapeConfig("decode", 32, 2, "decode")
    jdec, _ = j_steps.make_decode_step(jcfg, jmesh, JShape(
        "decode", 32, 2, "decode"))
    new = rng.integers(1, cfg.vocab_size, (2, 1)).astype(np.int32)
    lengths = np.array([5, 9], np.int32)
    jcache = j_init_cache(jcfg, 2, 32)
    jnt, jnew = jdec(jp, new, jcache, np.int32(9), lengths)
    dec = steps.make_decode_step(cfg, shape, device="cpu")
    nt, tcache = dec(tp, new, init_cache(cfg, 2, 32, device="cpu"),
                     np.int32(9), lengths)
    assert nt.numpy().tolist() == np.asarray(jnt).tolist()
    if arch == "llama3-8b":
        want_k = np.asarray(jnew["blocks"][0]["k"])
        assert _rel(tcache["k"].numpy(), want_k) <= REL
    with pytest.raises(ValueError, match="not the decode cell"):
        dec(tp, new, init_cache(cfg, 2, 16, device="cpu"), np.int32(9),
            lengths)


def test_prefill_step_casts_float32_masters():
    cfg = get_config("llama3-8b").reduced()        # bf16 compute
    from repro_torch.models.model import _cast_tree
    gen = torch.Generator().manual_seed(0)
    masters = init_params(cfg, gen, device="cpu", dtype=torch.float32)
    tokens = torch.randint(1, cfg.vocab_size, (1, 16), dtype=torch.int32)
    logits, _ = steps.make_prefill_step(cfg, device="cpu")(
        masters, {"tokens": tokens})
    want, _ = prefill(_cast_tree(cfg, masters), cfg, tokens)
    assert torch.equal(logits, want)
