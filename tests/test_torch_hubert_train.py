"""Training hubert-xlarge (the encoder) in the port on the CPU, against
the JAX package.

The reduced config, float32, weights from the reference ``init_params``
jittered (the zero-initialised LayerNorm scales would zero every hidden
state and every gradient behind them), batches from the token pipeline:
frame embeddings [B, S, D] and codebook labels, no tokens.

* ``forward_train``: loss and every gradient leaf (the tree has no
  ``embed``; ``pos_embed`` gets the rows the frames read) against
  ``jax.value_and_grad`` of ``repro.models.forward_train`` at relative
  1e-5, kernel and eager plans, remat on and off; the kernel plan runs
  its kernels once per layer (twice under remat) and the loss kernel
  once;
* the trainer: a JAX checkpoint resumed by the port's ``Trainer`` on the
  kernel plan, 3 AdamW steps at lr 3e-4 to the JAX trainer's losses, the
  JAX package restoring the port's checkpoint to the JAX run's weights and
  moments, and a port trainer resumed from its own step-2 checkpoint
  replaying step 3 bit for bit;
* the launcher: ``--arch hubert-xlarge --smoke --device cpu`` on both
  plans.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.distributed.optimizer import AdamWConfig as JAdamWConfig
from repro.distributed.optimizer import abstract_opt_state
from repro.distributed.optimizer import init_opt_state as j_init_opt_state
from repro.launch.mesh import make_host_mesh
from repro.models import abstract_params
from repro.models import forward_train as j_forward_train
from repro.models import init_params as j_init_params
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import restore_checkpoint as j_restore_checkpoint
from repro.train import save_checkpoint as j_save_checkpoint
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import TokenPipeline
from repro_torch.distributed import AdamWConfig
from repro_torch.launch.train import main as train_main
from repro_torch.models import (forward_train, params_from_numpy,
                                params_to_numpy)
from repro_torch.models.params import map_tree, tree_leaves
from repro_torch.train import Trainer, TrainerConfig, latest_checkpoint


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the module (restored after), so that the
    test workers running beside one another do not oversubscribe the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "hubert-xlarge"
REL = 1e-5
B, S = 2, 32
# Each layer's forward on the kernel plan: q, k, v through block_matmul,
# the MLP through streamed_mlp, the non-causal attention through the
# static flash kernel; the norms and the o-projection are PyTorch ops.
FORWARD_LAUNCHES = {"block_matmul": 3, "streamed_mlp": 1,
                    "flash_attention": 1}


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _configs(fused):
    j_cfg = dataclasses.replace(j_get_config(ARCH).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                                use_fused_kernels=fused)
    return j_cfg, t_cfg


def _count_calls(monkeypatch, names):
    """Count calls of the kernel wrappers the model layers reach (plain
    versions on the CPU, so their launch counters stay at 0)."""
    calls = dict.fromkeys(names, 0)
    for n in names:
        fn = getattr(K, n)

        def counted(*a, _n=n, _fn=fn, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(K, n, counted)
    return calls


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "eager"])
def test_forward_train_matches_reference(fused, monkeypatch):
    j_cfg, t_cfg = _configs(fused)
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(1), j_cfg), seed=7)
    batch = TokenPipeline(t_cfg, ShapeConfig("t", S, B, "train"),
                          seed=0).batch_at(0)
    assert sorted(batch) == ["embeds", "labels"]
    batch["labels"][0, :5] = -100
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_forward_train(p, j_cfg, j_batch)))(jp)
    j_flat = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    host = jax.tree.map(np.asarray, jp)
    calls = _count_calls(monkeypatch, list(FORWARD_LAUNCHES)
                         + ["streamed_xent_loss"])
    for remat in (True, False):
        params = params_from_numpy(host, t_cfg, device="cpu",
                                   dtype=torch.float32)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        for n in calls:
            calls[n] = 0
        loss = forward_train(params, t_cfg,
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()}, remat=remat)
        flat = iter(torch.autograd.grad(loss, leaves))
        grads = params_to_numpy(map_tree(lambda _: next(flat), params),
                                t_cfg)
        _rel_close(loss.detach().numpy(), j_loss)
        t_flat = jax.tree_util.tree_flatten_with_path(grads)[0]
        assert [p for p, _ in t_flat] == [p for p, _ in j_flat]
        for (_, got), (_, want) in zip(t_flat, j_flat):
            assert np.abs(want).max() > 0
            _rel_close(got, want)
        # The position table's rows past S get no gradient.
        assert not np.abs(grads["pos_embed"][S:]).max()
        runs = 2 if remat else 1
        want_calls = {n: runs * c * t_cfg.num_layers if fused else 0
                      for n, c in FORWARD_LAUNCHES.items()}
        want_calls["streamed_xent_loss"] = int(fused)
        assert calls == want_calls


SHAPE = ShapeConfig("t", 32, 2, "train")
J_SHAPE = JShapeConfig("t", 32, 2, "train")
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=3)


def test_trainer_and_checkpoints_move_between_the_packages(tmp_path):
    j_cfg, t_cfg = _configs(True)
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(0), j_cfg), seed=3)
    j_save_checkpoint(tmp_path / "start", 0, jp,
                      opt_state=j_init_opt_state(jp),
                      extra={"pipeline": {"step": 0}})
    for who in ("jax", "torch"):
        shutil.copytree(tmp_path / "start", tmp_path / who)
    tc = dict(total_steps=3, checkpoint_every=3, log_every=100)
    j_tr = JTrainer(j_cfg, J_SHAPE, make_host_mesh(1, 1),
                    JTrainerConfig(checkpoint_dir=str(tmp_path / "jax"), **tc),
                    JAdamWConfig(**OPT))
    j_tr.run()
    t_tr = Trainer(t_cfg, SHAPE,
                   TrainerConfig(checkpoint_dir=str(tmp_path / "torch"), **tc),
                   AdamWConfig(**OPT), device="cpu")
    assert t_tr.resume() and t_tr.step == 0
    t_tr.run()
    assert [s for s, _ in t_tr.history] == [s for s, _ in j_tr.history] \
        == [1, 2, 3]
    _rel_close([l for _, l in t_tr.history], [l for _, l in j_tr.history])

    path = latest_checkpoint(tmp_path / "torch")
    ab = abstract_params(j_cfg)
    assert "embed" not in ab
    step, params, opt, extra = j_restore_checkpoint(
        path, ab, opt_template=abstract_opt_state(ab))
    assert step == 3 and extra == {"pipeline": {"step": 3}}
    for mine, ref in ((params, j_tr.params), (opt.mu, j_tr.opt_state.mu),
                      (opt.nu, j_tr.opt_state.nu)):
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            _rel_close(a, b, 1e-4)


def test_resumed_trainer_replays(tmp_path):
    """A port trainer checkpointing at step 2, and a second one resuming
    there: its step 3 equals the first run's, bit for bit."""
    _, t_cfg = _configs(True)
    tc = dict(total_steps=3, checkpoint_every=2, log_every=100,
              keep_checkpoints=5)
    first = Trainer(t_cfg, SHAPE,
                    TrainerConfig(checkpoint_dir=str(tmp_path / "run"), **tc),
                    AdamWConfig(**OPT), device="cpu")
    first.run()
    first.ckpt.wait()
    shutil.copytree(tmp_path / "run" / "step-00000002",
                    tmp_path / "replay" / "step-00000002")
    second = Trainer(t_cfg, SHAPE, TrainerConfig(
        checkpoint_dir=str(tmp_path / "replay"), **tc),
        AdamWConfig(**OPT), device="cpu")
    assert second.resume() and second.step == 2
    second.run()
    assert second.history == first.history[2:]
    for a, b in zip(tree_leaves(second.params), tree_leaves(first.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("plan", [[], ["--fused"]], ids=["eager", "kernel"])
def test_launcher_trains_hubert_smoke_on_cpu(tmp_path, plan):
    assert train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq-len", "32", "--batch", "2",
                       "--ckpt", str(tmp_path)] + plan) == 0
