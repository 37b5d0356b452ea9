"""Training zamba2 in the port on the CPU, against the JAX package.

``zamba2-2.7b`` reduced, float32, weights from the reference
``init_params`` through the numpy bridge:

* ``forward_train``: the loss at relative 1e-5 and every gradient leaf
  (the Mamba2 leaves and the shared block's, which sums over its two
  applications) at 1e-4 against ``jax.value_and_grad`` of
  ``repro.models.forward_train``, kernel and eager plans, remat on and
  off; the kernel plan runs K13 once per layer (twice under remat), the
  shared block's kernels once per application and the loss kernel once;
* the trainer: a JAX checkpoint resumed by the port's ``Trainer`` on the
  kernel plan, 3 AdamW steps to the JAX trainer's losses (1e-4), and the
  JAX package restoring the port's checkpoint (the ``shared`` block
  included) to the JAX run's weights and moments;
* the launcher: ``--arch zamba2-2.7b --smoke --device cpu``.
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
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import restore_checkpoint as j_restore_checkpoint
from repro.train import save_checkpoint as j_save_checkpoint
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
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


ARCH = "zamba2-2.7b"
B, S = 2, 32
# Kernel-wrapper calls per forward on the kernel plan: K13 in every
# layer; K3 three times (q, k, v), the static flash kernel and K4 in each
# shared-block application; the loss once.
PER_LAYER = {"mamba2_ssd": 1}
PER_SHARED = {"rmsnorm_matmul": 3, "flash_attention": 1, "streamed_ffn": 1}


def _rel_close(got, want, tol=1e-5):
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


def _train_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -100
    return {"tokens": tokens, "labels": labels}


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
    jp = j_init_params(jax.random.PRNGKey(2), j_cfg)
    batch = _train_batch(j_cfg)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_forward_train(p, j_cfg, j_batch)))(jp)
    j_flat = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    host = jax.tree.map(np.asarray, jp)
    calls = _count_calls(monkeypatch, list(PER_LAYER) + list(PER_SHARED)
                         + ["block_matmul", "rms_norm_rows",
                            "streamed_xent_loss"])
    shared_apps = t_cfg.num_layers // t_cfg.shared_attn_every
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
        for (path, got), (_, want) in zip(t_flat, j_flat):
            _rel_close(got, want, 1e-4)
        assert np.abs(grads["shared"]["attn"]["wq"]).max() > 0
        assert np.abs(grads["blocks"][0]["mamba"]["a_log"]).max() > 0
        runs = 2 if remat else 1
        want_calls = {n: runs * c * t_cfg.num_layers if fused else 0
                      for n, c in PER_LAYER.items()}
        want_calls.update({n: runs * c * shared_apps if fused else 0
                           for n, c in PER_SHARED.items()})
        want_calls.update(block_matmul=0, rms_norm_rows=0,
                          streamed_xent_loss=int(fused))
        assert calls == want_calls


SHAPE = ShapeConfig("t", 32, 2, "train")
J_SHAPE = JShapeConfig("t", 32, 2, "train")
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=3)


def test_trainer_and_checkpoints_move_between_the_packages(tmp_path):
    j_cfg, t_cfg = _configs(True)
    jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
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
    _rel_close([l for _, l in t_tr.history], [l for _, l in j_tr.history],
               1e-4)

    path = latest_checkpoint(tmp_path / "torch")
    ab = abstract_params(j_cfg)
    step, params, opt, extra = j_restore_checkpoint(
        path, ab, opt_template=abstract_opt_state(ab))
    assert step == 3 and extra == {"pipeline": {"step": 3}}
    for mine, ref in ((params, j_tr.params), (opt.mu, j_tr.opt_state.mu),
                      (opt.nu, j_tr.opt_state.nu)):
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            _rel_close(a, b, 1e-4)
    assert "shared" in params


@pytest.mark.parametrize("plan", [[], ["--fused"]], ids=["eager", "kernel"])
def test_launcher_trains_zamba2_smoke_on_cpu(tmp_path, plan):
    assert train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq-len", "32", "--batch", "2",
                       "--ckpt", str(tmp_path)] + plan) == 0
