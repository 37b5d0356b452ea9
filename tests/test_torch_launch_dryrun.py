"""``python -m repro_torch.launch.dryrun`` on the CPU at full width.

* ``--all --device cpu`` as a subprocess: every ``cells()`` cell planned,
  verified clean, sized and counted (0 failures, exit code 0), the
  reference's skip lines, a record per cell with the reference's keys
  (``mesh`` "1", ``chips`` 1), exact parameter bytes, ``fits`` null on
  the CPU;
* rwkv6-7b's prefill and train cells under ``--perf`` (``wkv6_chunked``);
* the meshes and pin modes raise ``NotImplementedError`` naming ROADMAP
  queue 1 item 10; without a card and without ``--device cpu`` it raises
  before counting anything.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import skipped_cells as j_skipped_cells
from repro_torch.configs import cells, get_shape
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import storage_bytes
from repro_torch.models import abstract_params

ROOT = Path(__file__).resolve().parents[1]
# The reference's record (``repro/launch/dryrun.py:39-95``).
KEYS = {"arch", "shape", "mesh", "chips", "kind", "perf", "lower_s",
        "compile_s", "memory", "cost_xla_raw", "analyze_s", "cost",
        "collectives", "roofline"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "peak_bytes"}
ROOFLINE = {"compute_s", "memory_s", "collective_s", "bound",
            "step_s_lower_bound", "model_flops", "hlo_flops_per_chip",
            "useful_flops_ratio", "mfu_upper_bound"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small CPU ops: one intra-op thread (restored after the
    module), so that test workers beside one another do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(*argv, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *argv, "--device", "cpu", "--out", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600, cwd=ROOT)


def test_all_cells_at_full_width(tmp_path):
    got = _run("--all", out=tmp_path)
    assert got.returncode == 0, got.stderr[-3000:]
    lines = got.stdout.splitlines()
    want = [(c.name, s.name) for c, s in cells()]
    assert lines[-1] == f"[dryrun] done: {len(want)} ok, 0 failed"
    skips = [ln for ln in lines if ln.startswith("[dryrun] SKIP")]
    assert skips == [f"[dryrun] SKIP {a} x {s}: {r}"
                     for a, s, r in j_skipped_cells()]
    assert not list(tmp_path.glob("*__FAILED.json"))
    for arch, shape in want:
        rec = json.loads((tmp_path / f"{arch}__{shape}__pod1.json")
                         .read_text())
        assert KEYS <= set(rec), arch
        assert MEMORY <= set(rec["memory"]) and \
            ROOFLINE <= set(rec["roofline"])
        assert (rec["mesh"], rec["chips"], rec["device"]) == ("1", 1, "cpu")
        assert rec["plan"]["clean"], (arch, shape, rec["plan"])
        assert rec["memory"]["fits"] is None
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
        assert rec["counted_plan"] == "eager"
        assert rec["roofline"]["collective_s"] == 0.0
        cfg = next(c for c, s in cells() if c.name == arch)
        params = storage_bytes(abstract_params(cfg))
        extra = rec["memory"]["argument_bytes"] - params
        assert extra > 0 if get_shape(shape).kind != "train" else \
            extra > 2 * params


def test_rwkv6_perf_cells(tmp_path):
    for shape in ("prefill_32k", "train_4k"):
        got = _run("--arch", "rwkv6-7b", "--shape", shape, "--perf",
                   out=tmp_path)
        assert got.returncode == 0, got.stderr[-3000:]
        rec = json.loads((tmp_path / f"rwkv6-7b__{shape}__pod1__perf_all"
                          ".json").read_text())
        assert rec["perf"] == "all" and rec["plan"]["clean"]
        assert rec["roofline"]["useful_flops_ratio"] > 0.5


def test_meshes_and_no_card_raise():
    for argv in (["--all", "--multi-pod"], ["--all", "--both-meshes"]):
        with pytest.raises(NotImplementedError, match="queue 1 item 10"):
            dryrun.main(argv + ["--device", "cpu"])
    for argv in (["--arch", "llama3-8b", "--shape", "train_4k"],
                 ["--all"]):
        with pytest.raises(NotImplementedError, match="queue 1 item 10"):
            dryrun.main(argv + ["--perf", "sp", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        dryrun.run_cell("llama3-8b", "train_4k", perf="embed",
                        device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.main(["--all"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.run_cell("llama3-8b", "train_4k")
