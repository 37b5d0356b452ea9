"""Training rwkv6 in the port on the CPU, against the JAX package.

``rwkv6-7b`` reduced (2 layers), float32, weights from the reference
``init_params`` jittered (LayerNorm scales at zero would leave only the
embedding and the LM head with a gradient) and bridged through numpy:

* ``forward_train``: the loss at relative 1e-5 and every gradient leaf
  (the time-mix and channel-mix leaves, ``u`` and ``w_bias`` included) at
  1e-4 against ``jax.value_and_grad`` of ``repro.models.forward_train``,
  kernel and eager plans, remat on and off; the kernel plan runs K14 once
  per layer (twice under remat) and the loss kernel once, and the
  row-norm and ``block_matmul`` kernels never (the reference leaves the
  norms and projections to XLA when training);
* the trainer: a JAX checkpoint resumed by the port's ``Trainer`` on the
  kernel plan, 3 AdamW steps to the JAX trainer's losses (1e-4), and the
  JAX package restoring the port's checkpoint to the JAX run's weights
  and moments;
* the launcher: ``--arch rwkv6-7b --smoke --device cpu``, both plans.
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


ARCH = "rwkv6-7b"
B, S = 2, 32


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
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(2), j_cfg), seed=2)
    batch = _train_batch(j_cfg)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_forward_train(p, j_cfg, j_batch)))(jp)
    j_flat = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    host = jax.tree.map(np.asarray, jp)
    calls = _count_calls(monkeypatch, ["wkv6", "block_matmul",
                                       "layer_norm_rows",
                                       "streamed_xent_loss"])
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
        for sub, name in (("tm", "u"), ("tm", "w_bias"), ("tm", "mix_w"),
                          ("cm", "mix_r")):
            assert np.abs(grads["blocks"][0][sub][name]).max() > 0
        runs = 2 if remat else 1
        assert calls == {"wkv6": runs * t_cfg.num_layers if fused else 0,
                         "block_matmul": 0, "layer_norm_rows": 0,
                         "streamed_xent_loss": int(fused)}


SHAPE = ShapeConfig("t", 32, 2, "train")
J_SHAPE = JShapeConfig("t", 32, 2, "train")
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=3)


def test_trainer_and_checkpoints_move_between_the_packages(tmp_path):
    j_cfg, t_cfg = _configs(True)
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(0), j_cfg), seed=0)
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
    assert set(params["blocks"][0]) == {"ln1", "ln2", "tm", "cm"}


@pytest.mark.parametrize("plan", [[], ["--fused"]], ids=["eager", "kernel"])
def test_launcher_trains_rwkv6_smoke_on_cpu(tmp_path, plan):
    assert train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq-len", "32", "--batch", "2",
                       "--ckpt", str(tmp_path)] + plan) == 0
