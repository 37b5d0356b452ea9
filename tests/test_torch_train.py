"""The port's training path on the CPU against the JAX package.

Same inputs (numpy-seeded; weights from the reference ``init_params``
through the numpy bridge, float32), reduced configs:

* each autograd wrapper (kernel forward, eager backward): its grads equal
  the eager formulation's autograd grads bit for bit, and ``jax.vjp`` of
  the reference wrapper at relative 1e-5;
* ``forward_train``: loss and every gradient leaf against
  ``jax.value_and_grad(repro.models.forward_train)`` at relative 1e-5
  (max |diff| over max |ref|, per leaf, in the reference's layout), for
  llama3-8b-reduced and jittered gpt2-reduced, kernel and eager plans,
  with and without remat; under remat each kernel runs twice per step;
* the data pipeline bit for bit, AdamW and its schedule;
* checkpoints moving between the packages: the port's ``Trainer`` resumes
  from a JAX checkpoint and gives the JAX trainer's losses, and the JAX
  package restores the port's checkpoint; corruption is detected and an
  injected failure is recovered; the launcher runs.
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
from repro.data import TokenPipeline as JTokenPipeline
from repro.distributed.optimizer import AdamWConfig as JAdamWConfig
from repro.distributed.optimizer import abstract_opt_state
from repro.distributed.optimizer import adamw_update as j_adamw_update
from repro.distributed.optimizer import init_opt_state as j_init_opt_state
from repro.distributed.optimizer import lr_schedule as j_lr_schedule
from repro.launch.mesh import make_host_mesh
from repro.models import abstract_params
from repro.models import forward_train as j_forward_train
from repro.models import init_params as j_init_params
from repro.models import layers as JL
from repro.serving.accuracy import jitter_params
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import restore_checkpoint as j_restore_checkpoint
from repro.train import save_checkpoint as j_save_checkpoint
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import TokenPipeline
from repro_torch.distributed import (AdamWConfig, adamw_update,
                                     init_opt_state, lr_schedule)
from repro_torch.launch.train import main as train_main
from repro_torch.models import (forward_train, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import layers as L
from repro_torch.models.params import map_tree, tree_leaves
from repro_torch.train import (Trainer, TrainerConfig, latest_checkpoint,
                               restore_checkpoint)

REL = 1e-5


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------- autograd wrappers

def _wrapper_case(name, rng):
    """(numpy inputs, port wrapper, port eager formulation, reference
    wrapper) for one fused stage at a reduced width."""
    b, s, d, f = 2, 8, 32, 48
    x = _rand(rng, b, s, d)
    if name == "norm_matmul":
        args = (x, _rand(rng, d, scale=0.1), _rand(rng, d, 24, scale=0.2))
        return (args, lambda x, s, w: L.fused_norm_matmul(x, s, w),
                lambda x, s, w: L.rms_norm(x, s) @ w,
                lambda x, s, w: JL.fused_norm_matmul(x, s, w))
    if name == "matmul":
        args = (x, _rand(rng, d, 24, scale=0.2))
        return (args, L.fused_matmul, lambda x, w: x @ w, JL.fused_matmul)
    if name == "attention":
        q = _rand(rng, b, 16, 4, 16)
        k, v = _rand(rng, b, 16, 2, 16), _rand(rng, b, 16, 2, 16)
        return ((q, k, v), L.fused_attention,
                lambda q, k, v: L.streaming_attention(q, k, v, causal=True),
                lambda q, k, v: JL.fused_attention(q, k, v, causal=True))
    gated = name.startswith("ffn")
    act = "silu" if gated else "gelu"
    names = ("wg", "wu", "wd") if gated else ("wu", "wd")
    ws = tuple(_rand(rng, *((f, d) if n == "wd" else (d, f)), scale=0.2)
               for n in names)
    args = (x,) + ws
    if name.endswith("norm"):
        args += (_rand(rng, d, scale=0.1),)

    def split(a):
        p = dict(zip(names, a[1:1 + len(names)]))
        return a[0], p, (a[-1] if name.endswith("norm") else None)

    def port(*a):
        x, p, ns = split(a)
        return L.fused_ffn(x, p, activation=act, gated=gated, norm_scale=ns)

    def eager(*a):
        x, p, ns = split(a)
        h = L.rms_norm(x, ns) if ns is not None else x
        return L.ffn(h, p, activation=act, gated=gated)

    def ref(*a):
        x, p, ns = split(a)
        return JL.fused_ffn(x, p, activation=act, gated=gated, norm_scale=ns)

    return args, port, eager, ref


@pytest.mark.parametrize("name", ["norm_matmul", "matmul", "ffn_norm", "ffn",
                                  "mlp", "mlp_norm", "attention"])
def test_wrapper_grads_are_eager_grads_and_match_the_reference(name):
    rng = np.random.default_rng(11)
    args, port, eager, ref = _wrapper_case(name, rng)
    t_in = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = port(*t_in)
    g = _rand(rng, *out.shape)
    got = torch.autograd.grad(out, t_in, torch.from_numpy(g))
    e_in = [torch.from_numpy(a).requires_grad_(True) for a in args]
    want = torch.autograd.grad(eager(*e_in), e_in, torch.from_numpy(g))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    j_out, vjp = jax.vjp(ref, *map(jnp.asarray, args))
    _rel_close(out.detach().numpy(), j_out)
    for a, b in zip(got, vjp(jnp.asarray(g))):
        _rel_close(a.numpy(), b)
    with torch.no_grad():            # serving: the kernel alone, no node
        assert port(*t_in).grad_fn is None


# ----------------------------------------------------- forward_train

B, S = 2, 32
# The kernels each layer's forward runs once (K3 three times for q, k, v).
FORWARD_LAUNCHES = {
    "llama3-8b": {"rmsnorm_matmul": 3, "streamed_ffn": 1,
                  "flash_attention": 1},
    "gpt2": {"block_matmul": 3, "streamed_mlp": 1, "flash_attention": 1},
}


def _configs(arch, fused):
    j_cfg = dataclasses.replace(j_get_config(arch).reduced(),
                                dtype="float32", use_fused_kernels=fused)
    t_cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
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
@pytest.mark.parametrize("arch", ["llama3-8b", "gpt2"])
def test_forward_train_matches_reference(arch, fused, monkeypatch):
    j_cfg, t_cfg = _configs(arch, fused)
    jp = j_init_params(jax.random.PRNGKey(0), j_cfg)
    if arch == "gpt2":           # zero LayerNorm scales zero every logit
        jp = jitter_params(jp, 5)
    batch = _train_batch(j_cfg)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_forward_train(p, j_cfg, j_batch)))(jp)
    j_flat = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    host = jax.tree.map(np.asarray, jp)
    per_layer = FORWARD_LAUNCHES[arch]
    calls = _count_calls(monkeypatch, list(per_layer) + ["streamed_xent_loss"])
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
        # The forward's kernels, plus the re-run of each layer under remat;
        # the loss kernel once, outside the layers.
        runs = 2 if remat else 1
        want_calls = {n: runs * c * t_cfg.num_layers if fused else 0
                      for n, c in per_layer.items()}
        want_calls["streamed_xent_loss"] = int(fused)
        assert calls == want_calls


# ---------------------------------------------------- data, optimizer

def test_pipeline_batches_are_the_reference_batches():
    cfg, j_cfg = get_config("llama3-8b").reduced(), \
        j_get_config("llama3-8b").reduced()
    shape = ShapeConfig("t", 64, 4, "train")
    j_shape = JShapeConfig("t", 64, 4, "train")
    for shard in (0, 1):
        mine = TokenPipeline(cfg, shape, seed=7, num_shards=2, shard_id=shard)
        ref = JTokenPipeline(j_cfg, j_shape, seed=7, num_shards=2,
                             shard_id=shard)
        for _ in range(3):
            a, b = next(mine), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
        assert mine.state_dict() == ref.state_dict() == {"step": 3}


def test_adamw_update_and_schedule_match_reference():
    rng = np.random.default_rng(3)
    shapes = {"a": (8, 5), "b": (7,), "c": (3, 4, 2)}
    params = {k: _rand(rng, *s) for k, s in shapes.items()}
    grads = {k: _rand(rng, *s, scale=2.0) for k, s in shapes.items()}
    mu = {k: _rand(rng, *s, scale=0.1) for k, s in shapes.items()}
    nu = {k: np.abs(_rand(rng, *s, scale=0.1)) for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20)
    cfg, j_cfg = AdamWConfig(**kw), JAdamWConfig(**kw)
    j_state = j_init_opt_state(params)._replace(
        step=jnp.int32(4), mu=jax.tree.map(jnp.asarray, mu),
        nu=jax.tree.map(jnp.asarray, nu))
    j_p, j_s, j_m = j_adamw_update(j_cfg, jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, grads), j_state)
    t = lambda tree: {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    state = init_opt_state(t(params))._replace(
        step=torch.tensor(4, dtype=torch.int32), mu=t(mu), nu=t(nu))
    p, s, m = adamw_update(cfg, t(params), t(grads), state)
    assert int(s.step) == int(j_s.step) == 5
    for k in shapes:
        _rel_close(p[k].numpy(), j_p[k], 1e-6)
        _rel_close(s.mu[k].numpy(), j_s.mu[k], 1e-6)
        _rel_close(s.nu[k].numpy(), j_s.nu[k], 1e-6)
    for k in ("grad_norm", "lr"):
        _rel_close(m[k].numpy(), j_m[k], 1e-6)
    for step in range(24):
        assert float(lr_schedule(cfg, step)) == float(
            j_lr_schedule(j_cfg, jnp.int32(step)))


# ------------------------------------------------------- checkpoints

SHAPE = ShapeConfig("t", 32, 2, "train")
J_SHAPE = JShapeConfig("t", 32, 2, "train")
# AdamW's default learning rate with a one-step warmup.  Adam divides each
# element's step by its own gradient scale, so where a gradient is tiny its
# float32 rounding moves the update by up to a learning rate: at lr 1e-2
# the JAX package's kernel and eager plans end 3 steps apart by 4.8e-4 of
# the largest weight, at 3e-4 by 1.5e-5 (CPU, llama3-8b reduced).
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=3)


def test_checkpoints_move_between_the_packages(tmp_path):
    """A JAX checkpoint resumed by the port's trainer; both trainers run 3
    steps from it (eager plan, float32) to the same losses; the JAX package
    restores the port's final checkpoint to the JAX run's arrays."""
    j_cfg, t_cfg = _configs("llama3-8b", False)
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
    assert path.name == "step-00000003"
    ab = abstract_params(j_cfg)
    step, params, opt, extra = j_restore_checkpoint(
        path, ab, opt_template=abstract_opt_state(ab))
    assert step == 3 and extra == {"pipeline": {"step": 3}}
    assert int(opt.step) == int(j_tr.opt_state.step) == 3
    for mine, ref in ((params, j_tr.params), (opt.mu, j_tr.opt_state.mu),
                      (opt.nu, j_tr.opt_state.nu)):
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
            _rel_close(a, b, 1e-4)


def test_checkpoint_corruption_is_detected(tmp_path):
    _, t_cfg = _configs("gpt2", False)
    tr = Trainer(t_cfg, SHAPE, TrainerConfig(
        total_steps=1, checkpoint_every=1, checkpoint_dir=str(tmp_path),
        log_every=100), device="cpu")
    tr.run()
    path = latest_checkpoint(tmp_path)
    step, params, opt, _ = restore_checkpoint(path, t_cfg, device="cpu")
    assert step == 1 and int(opt.step) == 1
    for a, b in zip(tree_leaves(params), tree_leaves(tr.params)):
        assert torch.equal(a, b.detach())
    victim = path / "params__lm_head.npy"
    arr = np.load(victim)
    arr.flat[0] += 1.0
    np.save(victim, arr)
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(path, t_cfg, device="cpu")


def test_trainer_recovers_from_injected_failure(tmp_path):
    _, t_cfg = _configs("llama3-8b", False)
    tcfg = TrainerConfig(total_steps=6, checkpoint_every=2,
                         checkpoint_dir=str(tmp_path), log_every=100)
    crashed = {"done": False}

    def failure_hook(step):
        if step == 3 and not crashed["done"]:
            crashed["done"] = True
            raise KeyboardInterrupt("simulated preemption")

    t1 = Trainer(t_cfg, SHAPE, tcfg, failure_hook=failure_hook, device="cpu")
    with pytest.raises(KeyboardInterrupt):
        t1.run()
    t1.ckpt.wait()
    assert latest_checkpoint(tmp_path) is not None
    t2 = Trainer(t_cfg, SHAPE, tcfg, device="cpu")
    assert t2.resume() and t2.step == 2
    metrics = t2.run()
    assert t2.step == 6 and np.isfinite(metrics["loss"])
    # The replayed steps repeat the first run's losses (same data, same
    # weights from the checkpoint).
    assert [l for _, l in t2.history][:1] == [l for _, l in t1.history][2:3]


@pytest.mark.parametrize("plan", [[], ["--fused"]], ids=["eager", "kernel"])
def test_launcher_trains_gpt2_smoke_on_cpu(tmp_path, plan):
    assert train_main(["--arch", "gpt2", "--smoke", "--device", "cpu",
                       "--steps", "2", "--seq-len", "32", "--batch", "2",
                       "--ckpt", str(tmp_path)] + plan) == 0
    assert latest_checkpoint(tmp_path) is None       # every 25 steps
    with pytest.raises(SystemExit):
        train_main(["--arch", "bert", "--device", "cpu"])
