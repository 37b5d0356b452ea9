"""The tensor-core kernels K5 (``block_matmul``), K7 and K2 (the static
and offset branches of flash attention) and the streamed FFN (K4, K6,
K10b, K10c) in bf16, on the CPU.

Their CUDA code runs only on the card (``chip_smoke.py`` holds it there
against the plain versions, row by row and bit for bit where the paths
need it).  Here: the split plan that keeps K5's rows invariant up to 64
rows, the route each dtype and branch takes to its C entry point (a fake
library stands in for the build), the profile's attribution of every
``__global__`` function, and the plain static attention against the
interpret-mode Pallas kernel at the new kernel's tile edges.
The offset attention's (K2) is in ``test_torch_tensorcore_offset.py``, the
FFN's plan and arguments are in ``test_torch_tensorcore_ffn.py``.
"""

import ast
import functools
import importlib
import math
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention_2d as j_flash_2d
from repro_torch import kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import (MMA_BN, ROW_INVARIANT_T, cdiv,
                                       mma_plan)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parents[1]
# The wrapper modules (the package exports functions of the same names).
bm_mod = importlib.import_module("repro_torch.kernels.block_matmul")
fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")
ffn_mod = importlib.import_module("repro_torch.kernels.streamed_ffn")
# (K, N) of every block_matmul call on a path: gpt2's projections and LM
# head, llama3's o-projection, granite-3b's router and o-projection,
# zamba2's o-projection, rwkv6's LM head.
PATH_KN = [(1024, 1024), (1024, 50432), (4096, 4096), (1536, 40),
           (1536, 1536), (2560, 2560), (4096, 65536)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("k,n", PATH_KN)
def test_mma_plan_splits_k_alike_up_to_64_rows(k, n, sms):
    _, bk1, kps1, splits1 = mma_plan(1, k, n, sms)
    for m in range(2, ROW_INVARIANT_T + 1):
        _, bk, kps, splits = mma_plan(m, k, n, sms)
        assert (bk, kps, splits) == (bk1, kps1, splits1), m
    for m in (1, 17, 64, 65, 128, 992, 8192):
        _, bk, kps, splits = mma_plan(m, k, n, sms)
        assert kps % bk == 0
        assert (splits - 1) * kps < k <= splits * kps


class _FakeLib:
    """Stands in for a built library: each C entry point records its
    library, symbol and arguments and returns 0 (cudaSuccess)."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, symbol):
        def entry(*args):
            self.calls.append((self.name, symbol, args))
            return 0
        return entry


@pytest.fixture
def card_route(monkeypatch):
    """Force the CUDA route for CPU tensors, with every library a
    ``_FakeLib``; returns the list of recorded launches."""
    calls = []
    for mod in (bm_mod, fa_mod, ffn_mod):
        monkeypatch.setattr(mod, "kernel_path", lambda t: "cuda")
        mod._entry.cache_clear()
    for mod in (bm_mod, ffn_mod):
        monkeypatch.setattr(mod, "sm_count", lambda device: 132)
        monkeypatch.setattr(mod, "_WORKSPACE", {})
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(name, calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    yield calls
    for mod in (bm_mod, fa_mod, ffn_mod):
        mod._entry.cache_clear()


def _qkv(dtype, d=64):
    """q [4, 40, d] and one k/v tensor [2, 40, d] for both: GQA group 2."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(4, 40, d, generator=gen).to(dtype)
    kv = torch.randn(2, 40, d, generator=gen).to(dtype)
    return q, kv, kv


def _codes(dtype, code):
    """q and int8 / fp8 K/V codes with their per-position scales."""
    q, kv, _ = _qkv(dtype)
    c = kv.float().clamp(-1, 1).to(code)
    return q, c, c, dict(k_scale=torch.ones(2, 40), v_scale=torch.ones(2, 40))


def _ffn(dtype, kind):
    """A call of one FFN instance at 4 rows, D 32, F 64 (int8 codes and
    float32 scales for the twins)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 32, generator=gen).to(dtype)
    w = torch.randn(32, 64, generator=gen).to(dtype)
    wd = torch.randn(64, 32, generator=gen).to(dtype)
    s = torch.zeros(32, dtype=dtype)
    c, cd = w.to(torch.int8), wd.to(torch.int8)
    q8 = dict(wu_scale=torch.ones(64), wd_scale=torch.ones(32))
    return {
        "ffn": lambda: K.streamed_ffn(x, w, w, wd, norm_scale=s),
        "ffn_gelu": lambda: K.streamed_ffn(x, w, w, wd, activation="gelu"),
        "ffn_gelu_norm": lambda: K.streamed_ffn(
            x, w, w, wd, activation="gelu", norm_scale=s),
        "mlp": lambda: K.streamed_mlp(x, w, wd),
        "ffn_w8": lambda: K.streamed_ffn_w8(
            x, c, c, cd, wg_scale=torch.ones(64), norm_scale=s, **q8),
        "ffn_gelu_w8": lambda: K.streamed_ffn_w8(
            x, c, c, cd, wg_scale=torch.ones(64), activation="gelu", **q8),
        "ffn_gelu_norm_w8": lambda: K.streamed_ffn_w8(
            x, c, c, cd, wg_scale=torch.ones(64), activation="gelu",
            norm_scale=s, **q8),
        "mlp_w8": lambda: K.streamed_mlp_w8(x, c, cd, **q8)}[kind]()


BF16, F32 = torch.bfloat16, torch.float32
FFN_COUNTERS = {"ffn": K.streamed_ffn, "ffn_gelu": K.streamed_ffn,
                "ffn_gelu_norm": K.streamed_ffn,
                "mlp": K.streamed_mlp, "ffn_w8": K.streamed_ffn_w8,
                "ffn_gelu_w8": K.streamed_ffn_w8,
                "ffn_gelu_norm_w8": K.streamed_ffn_w8,
                "mlp_w8": K.streamed_mlp_w8}
ROUTES = {
    # case: (call, library, symbol, wrapper whose count rises)
    "block_matmul bf16": (
        lambda: K.block_matmul(torch.zeros(4, 1024, dtype=BF16),
                               torch.zeros(1024, 1024, dtype=BF16)),
        "block_matmul", "repro_block_matmul_mma_bf16", K.block_matmul),
    "block_matmul f32": (
        lambda: K.block_matmul(torch.zeros(4, 1024), torch.zeros(1024, 1024)),
        "block_matmul", "repro_block_matmul_f32", K.block_matmul),
    "static bf16": (
        lambda: K.flash_attention_2d(*_qkv(BF16), kv_group=2),
        "flash_mma", "repro_flash_static_mma_bf16", K.flash_attention_static),
    "static bf16 D=80": (
        lambda: K.flash_attention_static(*_qkv(BF16, 80), kv_group=2),
        "flash_mma", "repro_flash_static_mma_bf16", K.flash_attention_static),
    "static bf16 D=128": (
        lambda: K.flash_attention(*(t.transpose(0, 1)[None].contiguous()
                                    for t in _qkv(BF16, 128))),
        "flash_mma", "repro_flash_static_mma_bf16", K.flash_attention_static),
    "static f32": (
        lambda: K.flash_attention_2d(*_qkv(F32), kv_group=2),
        "flash_attention", "repro_flash_static_f32",
        K.flash_attention_static),
    "static bf16, negative scale": (
        lambda: K.flash_attention_2d(*_qkv(BF16), kv_group=2, scale=-0.125),
        "flash_mma", "repro_flash_static_mma_bf16", K.flash_attention_static),
    "offset bf16 (K2)": (
        lambda: K.flash_attention_2d(*_qkv(BF16), q_offset=0, kv_group=2),
        "flash_mma", "repro_flash_offset_mma_bf16", K.flash_attention_2d),
    "offset bf16 D=128, negative scale (K2)": (
        lambda: K.flash_attention_2d(*_qkv(BF16, 128), q_offset=24,
                                     kv_len=40, kv_group=2, scale=-0.1),
        "flash_mma", "repro_flash_offset_mma_bf16", K.flash_attention_2d),
    "offset f32 (K2)": (
        lambda: K.flash_attention_2d(*_qkv(F32), q_offset=0, kv_group=2),
        "flash_attention", "repro_flash_offset_f32", K.flash_attention_2d),
    "offset over int8, bf16 (K9c)": (
        lambda: (lambda q, k, v, sc: K.flash_attention_2d_q(
            q, k, v, **sc, q_offset=0, kv_group=2))(
                *_codes(BF16, torch.int8)),
        "flash_mma", "repro_flash_offset_q_mma_bf16_i8",
        K.flash_attention_2d_q),
    "offset over fp8, f32 (K9c)": (
        lambda: (lambda q, k, v, sc: K.flash_attention_2d_q(
            q, k, v, **sc, q_offset=0, kv_group=2))(
                *_codes(F32, torch.float8_e4m3fn)),
        "flash_attention", "repro_flash_offset_q_f32_fp8",
        K.flash_attention_2d_q),
}
# Every FFN instance: bf16 to the tensor-core entry point, f32 to the
# CUDA-core one; the int8 twins in a library of their own.
ROUTES.update({
    f"{kind} {name}": (functools.partial(_ffn, dtype, kind),
                       "streamed_ffn_w8" if kind.endswith("_w8")
                       else "streamed_ffn",
                       f"repro_streamed_{kind}_{sym}", FFN_COUNTERS[kind])
    for kind in FFN_COUNTERS
    for name, dtype, sym in (("bf16", BF16, "mma_bf16"),
                             ("f32", F32, "f32"))})


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_each_dtype_and_branch_reaches_its_entry_point(card_route, case):
    call, lib, symbol, counter = ROUTES[case]
    before = counter.launches
    for i in range(1, 3):
        call()
        assert [(c[0], c[1]) for c in card_route] == [(lib, symbol)] * i
        assert counter.launches == before + i


@pytest.mark.parametrize("m,k,n", [(4, 1024, 1024), (64, 1536, 40),
                                   (128, 4096, 4096), (8192, 1024, 1024),
                                   (4, 1000, 1001), (20, 1024, 50432)])
def test_bf16_block_matmul_passes_its_plan(card_route, m, k, n):
    """The entry point gets ``mma_plan``'s split, partials and arrival
    counters (from the workspace, with room for the split) only when it
    splits, and the scalar-load flag exactly where a row is not a whole
    number of 16-byte vectors."""
    x = torch.zeros(m, k, dtype=torch.bfloat16)
    w = torch.zeros(k, n, dtype=torch.bfloat16)
    K.block_matmul(x, w)
    (_, _, args), = card_route
    part, ctr = args[3], args[4]
    bm, _, k_per_split, splits = mma_plan(m, k, n, 132)
    assert args[5:11] == (m, k, n, k_per_split, splits,
                          int(k % 8 == 0 and n % 8 == 0))
    assert (part is not None) == (ctr is not None) == (splits > 1)
    if splits > 1:
        part_ws, ctr_ws = bm_mod._WORKSPACE[x.device]
        assert (part, ctr) == (part_ws.data_ptr(), ctr_ws.data_ptr())
        assert part_ws.numel() >= splits * m * n
        assert ctr_ws.numel() >= cdiv(n, MMA_BN) * cdiv(m, bm)
        assert not ctr_ws.any()


def _global_functions():
    """Every ``__global__`` function name in the kernel sources."""
    names = set()
    for src in sorted((ROOT / "src/repro_torch/kernels/csrc").glob("*.cu*")):
        text = src.read_text()
        for hit in re.finditer(r"__global__", text):
            rest = text[hit.end():]
            # Drop `void` and a `__launch_bounds__(...)` with nested parens.
            rest = re.sub(r"^\s*void\s+", "", rest)
            if rest.startswith("__launch_bounds__"):
                depth, i = 0, len("__launch_bounds__")
                while True:
                    depth += {"(": 1, ")": -1}.get(rest[i], 0)
                    i += 1
                    if depth == 0:
                        break
                rest = rest[i:]
            names.add(re.match(r"\s*(\w+)\s*\(", rest).group(1))
    return names


def _own_kernels():
    """``chip_smoke.OWN_KERNELS`` read with ``ast`` (not imported)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "OWN_KERNELS"
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no OWN_KERNELS")


def test_profile_attributes_every_global_function():
    names = _global_functions()
    assert {"flash_mma_kernel", "block_mma_kernel", "ffn_mma_kernel",
            "rms_rows_kernel", "flash_offset_kernel",
            "tiled_matmul_kernel", "streamed_ffn_kernel"} <= names
    keys = [k for k, _ in _own_kernels()]
    unmatched = sorted(n for n in names if not any(k in n for k in keys))
    assert not unmatched, unmatched
    # The new kernels go under their own stage, not under the old ones'.
    stage = dict(_own_kernels())
    for name in ("flash_mma_kernel", "block_mma_kernel", "ffn_mma_kernel",
                 "rms_rows_kernel"):
        hits = [k for k in stage if k in name]
        assert len(hits) == 1, (name, hits)


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 999])
def test_plain_static_flash_matches_pallas_at_tile_edges(s, d):
    """The plain version the card's kernel is held to, against the
    interpret-mode Pallas kernel at the tensor-core kernel's 64-row and
    64-key tile edges, GQA group 4, float32."""
    rng = np.random.default_rng(s * 1000 + d)
    q = rng.standard_normal((4, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, d)).astype(np.float32)
            for _ in range(2))
    got = ref.flash_attention_static(
        *(torch.from_numpy(a) for a in (q, k, v)), kv_len=s, kv_group=4,
        block_kv=64)
    want = j_flash_2d(*(jnp.asarray(a) for a in (q, k, v)), kv_len=s,
                      kv_group=4, scale=1.0 / math.sqrt(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

