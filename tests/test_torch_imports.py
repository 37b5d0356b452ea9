"""Import hygiene of the port, and ``chip_smoke.py`` refusing to run
without a card or without the repository."""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_port_imports_neither_jax_nor_the_reference():
    import repro_torch
    modules = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert {"repro_torch.serving.engine", "repro_torch.serving.prefix_cache",
            "repro_torch.kernels.paged_attention",
            "repro_torch.train.trainer", "repro_torch.distributed.optimizer",
            "repro_torch.data.pipeline", "repro_torch.launch.train",
            "repro_torch.launch.serve",
            "repro_torch.kernels.streamed_xent",
            "repro_torch.kernels.moe_experts",
            "repro_torch.configs.granite_moe_1b",
            "repro_torch.configs.granite_moe_3b",
            "repro_torch.kernels.mamba2_scan",
            "repro_torch.configs.zamba2_2p7b",
            "repro_torch.kernels.rwkv6_wkv",
            "repro_torch.configs.rwkv6_7b",
            "repro_torch.configs.qwen3_0p6b",
            "repro_torch.configs.qwen1p5_0p5b",
            "repro_torch.configs.qwen2_vl_2b",
            "repro_torch.configs.gemma3_4b",
            "repro_torch.configs.hubert_xlarge",
            "repro_torch.kernels.stream_converter",
            "repro_torch.runtime.simulator",
            "repro_torch.obs", "repro_torch.obs.events",
            "repro_torch.obs.metrics", "repro_torch.obs.export",
            "repro_torch.obs.__main__", "repro_torch.tuning",
            "repro_torch.tuning.table", "repro_torch.tuning.measure",
            "repro_torch.tuning.autotune",
            "repro_torch.tuning.__main__"} <= set(modules)
    assert {f"repro_torch.core.{m}" for m in (
        "affine", "itensor", "converter", "graph", "token_model",
        "fifo_sizing", "fusion", "platforms", "tiling", "trace", "dse",
        "partition", "allocation", "dma", "lowering",
        "stream_plan")} <= set(modules)
    assert {f"repro_torch.analysis.{m}" for m in (
        "diagnostics", "itensor_check", "effects", "sharding_check",
        "kernel_lint", "verify")} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"mods = {modules!r}\n"
        "for m in ['repro_torch'] + mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'"
        " or k.startswith('jax.') or k == 'repro'"
        " or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(modules)


def _no_result(out: subprocess.CompletedProcess) -> None:
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    _no_result(out)
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    _no_result(out)
