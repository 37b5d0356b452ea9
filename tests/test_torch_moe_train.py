"""Training granite-moe in the port on the CPU, against the JAX package.

Reduced configs (4 experts, top-2), float32, weights from the reference
``init_params`` through the numpy bridge:

* ``fused_moe_ffn`` (K12 forward, eager backward): its gradients equal
  the eager formulation's bit for bit (the router's through the gates
  included) and ``jax.vjp`` of the reference wrapper at relative 1e-5;
* ``forward_train``: loss and every gradient leaf (the router ``wr`` and
  the expert stacks included) against ``jax.value_and_grad`` of
  ``repro.models.forward_train`` at relative 1e-5, both granite configs,
  kernel and eager plans, remat on and off; the kernel plan runs K12 once
  per layer (twice under remat) and the loss kernel once;
* the trainer: a JAX checkpoint resumed by the port's ``Trainer`` on the
  kernel plan, 3 AdamW steps at lr 3e-4 to the JAX trainer's losses, and
  the JAX package restoring the port's checkpoint to the JAX run's
  weights and moments;
* the launcher: ``--arch granite-moe-1b-a400m --smoke --device cpu`` on
  both plans.
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
from repro.models import layers as JL
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
from repro_torch.models import layers as L
from repro_torch.models.params import map_tree, tree_leaves
from repro_torch.train import Trainer, TrainerConfig, latest_checkpoint

REL = 1e-5
ARCHS = ("granite-moe-1b-a400m", "granite-moe-3b-a800m")
B, S = 2, 32
# The kernels each layer's forward runs on the kernel plan (K3 three
# times for q, k, v); ln2 and the router product are PyTorch ops there.
FORWARD_LAUNCHES = {"rmsnorm_matmul": 3, "moe_experts": 1,
                    "flash_attention": 1}


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _configs(arch, fused):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                use_fused_kernels=fused)
    return j_cfg, t_cfg


def test_fused_moe_ffn_grads_are_eager_grads_and_match_the_reference():
    rng = np.random.default_rng(12)
    b, s, d, f, e, k = 2, 8, 32, 48, 8, 2
    x = _rand(rng, b, s, d)
    p = {"wr": _rand(rng, d, e, scale=d ** -0.5),
         "wg": _rand(rng, e, d, f, scale=d ** -0.5),
         "wu": _rand(rng, e, d, f, scale=d ** -0.5),
         "wd": _rand(rng, e, f, d, scale=f ** -0.5)}
    names = list(p)

    def port(x, *ws):
        return L.fused_moe_ffn(x, dict(zip(names, ws)), activation="silu",
                               top_k=k, router_kernel=False)

    def eager(x, *ws):
        return L.moe_ffn(x, dict(zip(names, ws)), activation="silu",
                         gated=True, top_k=k)

    def ref(x, *ws):
        return JL.fused_moe_ffn(x, dict(zip(names, ws)), activation="silu",
                                top_k=k, block_t=8)

    args = [x] + [p[n] for n in names]
    t_in = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = port(*t_in)
    g = _rand(rng, *out.shape)
    got = torch.autograd.grad(out, t_in, torch.from_numpy(g))
    e_in = [torch.from_numpy(a).requires_grad_(True) for a in args]
    want = torch.autograd.grad(eager(*e_in), e_in, torch.from_numpy(g))
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert got[1].abs().max() > 0                     # the router learns
    j_out, vjp = jax.vjp(ref, *map(jnp.asarray, args))
    _rel_close(out.detach().numpy(), j_out)
    for a, w in zip(got, vjp(jnp.asarray(g))):
        _rel_close(a.numpy(), w)
    with torch.no_grad():            # serving: the kernel alone, no node
        assert port(*t_in).grad_fn is None


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
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch, fused, monkeypatch):
    j_cfg, t_cfg = _configs(arch, fused)
    jp = j_init_params(jax.random.PRNGKey(ARCHS.index(arch)), j_cfg)
    batch = _train_batch(j_cfg)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_forward_train(p, j_cfg, j_batch)))(jp)
    j_flat = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    host = jax.tree.map(np.asarray, jp)
    calls = _count_calls(monkeypatch, list(FORWARD_LAUNCHES)
                         + ["block_matmul", "rms_norm_rows",
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
            _rel_close(got, want)
        assert np.abs(grads["blocks"][0]["mlp"]["wr"]).max() > 0
        runs = 2 if remat else 1
        want_calls = {n: runs * c * t_cfg.num_layers if fused else 0
                      for n, c in FORWARD_LAUNCHES.items()}
        want_calls.update(block_matmul=0, rms_norm_rows=0,
                          streamed_xent_loss=int(fused))
        assert calls == want_calls


SHAPE = ShapeConfig("t", 32, 2, "train")
J_SHAPE = JShapeConfig("t", 32, 2, "train")
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=3)


def test_trainer_and_checkpoints_move_between_the_packages(tmp_path):
    j_cfg, t_cfg = _configs("granite-moe-1b-a400m", True)
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
    _rel_close([l for _, l in t_tr.history], [l for _, l in j_tr.history])

    path = latest_checkpoint(tmp_path / "torch")
    ab = abstract_params(j_cfg)
    step, params, opt, extra = j_restore_checkpoint(
        path, ab, opt_template=abstract_opt_state(ab))
    assert step == 3 and extra == {"pipeline": {"step": 3}}
    for mine, ref in ((params, j_tr.params), (opt.mu, j_tr.opt_state.mu),
                      (opt.nu, j_tr.opt_state.nu)):
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            _rel_close(a, b, 1e-4)


@pytest.mark.parametrize("plan", [[], ["--fused"]], ids=["eager", "kernel"])
def test_launcher_trains_granite_smoke_on_cpu(tmp_path, plan):
    assert train_main(["--arch", "granite-moe-1b-a400m", "--smoke",
                       "--device", "cpu", "--steps", "2", "--seq-len", "32",
                       "--batch", "2", "--ckpt", str(tmp_path)] + plan) == 0
