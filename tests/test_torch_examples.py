"""The port's four examples (``examples/torch_*.py``) on the CPU: each
``main`` with ``--device cpu`` at its smallest size prints its OK line
(the quickstart's K4 and K7 plain versions against ``kernels/ref.py``,
the explorer's plans clean for the CPU, every served request complete,
the trained loss falling), and without a card and without ``--device
cpu`` each raises before it runs anything."""

import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SMALL = {
    "torch_quickstart": [],
    "torch_dataflow_explorer": [],
    "torch_serve_lm": ["--requests", "2", "--prompt-len", "8",
                       "--new-tokens", "4"],
    "torch_train_lm": ["--steps", "6", "--d-model", "32", "--layers", "1",
                       "--seq-len", "32", "--batch", "2", "--vocab", "256"],
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small CPU ops: one intra-op thread (restored after the
    module), so that test workers beside one another do not oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_runs_on_cpu(name, capsys, tmp_path):
    argv = SMALL[name] + ["--device", "cpu"]
    if name == "torch_train_lm":
        argv += ["--ckpt", str(tmp_path)]
    out = _example(name).main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert name.removeprefix("torch_") + " OK" in lines
    if name == "torch_quickstart":
        assert out["completed"]
        assert out["streamed_ffn_err"] <= 1e-5
        assert out["flash_attention_err"] <= 1e-5
    elif name == "torch_train_lm":
        assert out[-1] < out[0]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_example_needs_a_card_or_the_cpu_asked(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(SMALL[name])
