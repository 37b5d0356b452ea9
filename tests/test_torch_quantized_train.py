"""Weight-quantized training in the port on the CPU, against the JAX
package.

Under ``w8`` (and ``w8_kv8``) the kernel plan's q/k/v and FFN stages run
their int8 twins forward, the weights quantized per output channel at
every call, and take the gradient of the reference's straight-through
estimator (``_w8_ste``): x's gradient through the dequantized weight, the
weight's as if it were unquantized.  Reduced configs (gemma3 cut to one
period, a local layer and a global one), float32, the JAX
``init_params`` jittered (gpt2's LayerNorm and gemma3's q/k norm scales
start at zero) and bridged with ``params_from_numpy``:

* ``forward_train`` under ``w8``, kernel plan: the loss and every
  gradient leaf at relative 1e-5 against ``jax.value_and_grad`` of the
  reference, whose wrappers run the interpret-mode Pallas twins forward
  and ``_w8_ste`` backward: llama3 (K10a, K10b SiLU-GLU with ln2 folded
  in), gpt2 (K5 for q/k/v, K10c) and gemma3 (K10a, K10b GELU-GLU with
  ln2 folded in), remat on and off, each twin once per layer (twice under
  remat) and its unquantized kernel never;
* ``w8_kv8`` trains exactly as ``w8`` (a KV mode does nothing to
  training), and on the eager plan neither package quantizes a weight;
* the plan's training ``w8`` flags equal ``repro.core.stream_plan``'s;
* two AdamW steps of the port's ``Trainer`` equal the JAX trainer's from
  the same checkpoint: the second step's forward quantizes the weights
  the first step moved (codes cached across steps fail it);
* cached ``(codes, scales)`` pairs are refused under grad; the launcher
  trains a ``w8`` config.
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
from test_torch_stream_plan import j_plan_for  # the reference on H100
from repro.distributed.optimizer import AdamWConfig as JAdamWConfig
from repro.distributed.optimizer import init_opt_state as j_init_opt_state
from repro.launch.mesh import make_host_mesh
from repro.models import forward_train as j_forward_train
from repro.models import init_params as j_init_params
from repro.models.model import resolve_plan as j_resolve_plan
from repro.serving.accuracy import jitter_params as j_jitter_params
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import save_checkpoint as j_save_checkpoint
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.stream_plan import STAGES, plan_for
from repro_torch.distributed import AdamWConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import (forward_train, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import layers as L
from repro_torch.models.model import resolve_plan
from repro_torch.models.params import map_tree, tree_leaves
from repro_torch.train import Trainer, TrainerConfig

REL = 1e-5
ARCHS = ("llama3-8b", "gpt2", "gemma3-4b")
B, S = 2, 40          # past gemma3's reduced 32-token window
# The kernels each layer's forward runs on the w8 kernel plan.
FORWARD_LAUNCHES = {
    "llama3-8b": {"rmsnorm_matmul_w8": 3, "streamed_ffn_w8": 1},
    "gpt2": {"block_matmul": 3, "streamed_mlp_w8": 1},
    "gemma3-4b": {"rmsnorm_matmul_w8": 3, "streamed_ffn_w8": 1},
}
KERNELS = ("rmsnorm_matmul_w8", "streamed_ffn_w8", "streamed_mlp_w8",
           "block_matmul", "rmsnorm_matmul", "streamed_ffn", "streamed_mlp",
           "flash_attention", "streamed_xent_loss")



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU runs here are many small ops: one intra-op thread
    each (restored after the module), so that the test workers running
    beside one another do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _configs(arch, quant="w8", fused=True):
    """The reduced configs (gemma3 cut to one period: a local layer and a
    global one)."""
    j_cfg, t_cfg = (dataclasses.replace(
        get(arch).reduced(), dtype="float32", use_fused_kernels=fused,
        quant=quant) for get in (j_get_config, get_config))
    if arch == "gemma3-4b":
        j_cfg, t_cfg = (dataclasses.replace(c, num_layers=2)
                        for c in (j_cfg, t_cfg))
    return j_cfg, t_cfg


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    batch = {n: rng.integers(0, vocab, (B, S)).astype(np.int32)
             for n in ("tokens", "labels")}
    batch["labels"][0, :5] = -100
    return batch


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


def _port_loss_and_grads(host, t_cfg, batch, remat=True):
    params = params_from_numpy(host, t_cfg, device="cpu",
                               dtype=torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = forward_train(params, t_cfg,
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         remat=remat)
    flat = iter(torch.autograd.grad(loss, leaves))
    grads = params_to_numpy(map_tree(lambda _: next(flat), params), t_cfg)
    return loss.detach(), jax.tree_util.tree_flatten_with_path(grads)[0]


def _port_loss(host, t_cfg, batch):
    """The loss alone, without autograd."""
    params = params_from_numpy(host, t_cfg, device="cpu",
                               dtype=torch.float32)
    with torch.no_grad():
        return forward_train(params, t_cfg, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Per arch, once: the jittered JAX weights as numpy, the batch, the
    reference's loss and gradient leaves (with paths) under w8 on the
    kernel plan, and the port's (remat on) with its kernel calls."""
    arch = request.param
    j_cfg, t_cfg = _configs(arch)
    jp = j_jitter_params(
        j_init_params(jax.random.PRNGKey(ARCHS.index(arch)), j_cfg), seed=5)
    batch = _batch(j_cfg.vocab_size)
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: j_forward_train(p, j_cfg, j_batch)))(jp)
    host = jax.tree.map(np.asarray, jp)
    with pytest.MonkeyPatch.context() as mp:
        calls = _count_calls(mp, KERNELS)
        port = _port_loss_and_grads(host, t_cfg, batch)
    return dict(arch=arch, host=host, batch=batch, j_loss=np.asarray(j_loss),
                j_flat=jax.tree_util.tree_flatten_with_path(j_grads)[0],
                port=port, calls=dict(calls))


def _want_calls(arch, t_cfg, remat):
    runs = 2 if remat else 1
    want = dict.fromkeys(KERNELS, 0)
    want.update({n: runs * c * t_cfg.num_layers
                 for n, c in FORWARD_LAUNCHES[arch].items()})
    want.update(flash_attention=runs * t_cfg.num_layers,
                streamed_xent_loss=1)
    return want


def test_forward_train_matches_reference(runs, monkeypatch):
    arch = runs["arch"]
    _, t_cfg = _configs(arch)
    calls = _count_calls(monkeypatch, KERNELS)
    remat_off = _port_loss_and_grads(runs["host"], t_cfg, runs["batch"],
                                     remat=False)
    for remat, (loss, t_flat), got_calls in (
            (True, runs["port"], runs["calls"]), (False, remat_off, calls)):
        _rel_close(loss.numpy(), runs["j_loss"])
        assert [p for p, _ in t_flat] == [p for p, _ in runs["j_flat"]]
        for (_, got), (_, want) in zip(t_flat, runs["j_flat"]):
            _rel_close(got, want)
        assert got_calls == _want_calls(arch, t_cfg, remat)


def test_w8_kv8_trains_exactly_as_w8(runs):
    loss, flat = _port_loss_and_grads(
        runs["host"], _configs(runs["arch"], "w8_kv8")[1], runs["batch"])
    assert torch.equal(loss, runs["port"][0])
    for (_, a), (_, b) in zip(flat, runs["port"][1]):
        assert np.array_equal(a, b)


def test_eager_plan_keeps_full_precision_weights(runs):
    """Neither package plans a kernel, so none quantizes a weight: the
    eager w8 loss is the unquantized one (and not the kernel plan's
    quantized one)."""
    arch, host, batch = runs["arch"], runs["host"], runs["batch"]
    for quant in ("w8", "w8_kv8"):
        j_cfg, t_cfg = _configs(arch, quant, fused=False)
        assert j_resolve_plan(j_cfg, B * S) is None
        assert resolve_plan(t_cfg, B * S) is None
    got = _port_loss(host, _configs(arch, "w8", False)[1], batch)
    assert torch.equal(got, _port_loss(host, _configs(arch, "none",
                                                      False)[1], batch))
    assert not torch.equal(got, runs["port"][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_training_plan_flags_w8_as_the_reference(arch):
    """The training token counts of the reduced and full configs: each
    stage's kernel and blocks, the ``w8`` flag among them, and the loss
    stage, as the reference plans them."""
    for red in (True, False):
        for quant in ("w8", "w8_kv8"):
            base, j_base = get_config(arch), j_get_config(arch)
            if red:
                base, j_base = base.reduced(), j_base.reduced()
            cfg = dataclasses.replace(base, use_fused_kernels=True,
                                      quant=quant)
            j_cfg = dataclasses.replace(j_base, use_fused_kernels=True,
                                        quant=quant)
            for tokens in ((B * S, 256) if red else (4096, 8192)):
                mine, ref = plan_for(cfg, tokens), j_plan_for(j_cfg, tokens)
                assert (mine.lm_head.implementation, mine.lm_head.blocks) \
                    == (ref.lm_head.implementation, ref.lm_head.blocks)
                kinds = [k for k, _ in mine.layers]
                assert kinds == [k for k, _ in ref.layers]
                for kind in kinds:
                    lp, rlp = mine.layer(kind), ref.layer(kind)
                    for stage in STAGES:
                        got, want = getattr(lp, stage), getattr(rlp, stage)
                        assert got.implementation == want.implementation
                        assert got.blocks == want.blocks, (arch, stage)
                    assert ("w8", 1) in lp.ffn.blocks
                    assert (("w8", 1) in lp.qkv.blocks) == (
                        lp.qkv.implementation == "rmsnorm_matmul")


SHAPE = ShapeConfig("t", S, B, "train")
J_SHAPE = JShapeConfig("t", S, B, "train")
OPT = dict(lr=3e-4, warmup_steps=1, total_steps=2)


def test_two_adamw_steps_equal_the_jax_trainer(tmp_path):
    """llama3 under w8 (K10a, K10b): the losses of both steps and the
    weights and moments after them."""
    j_cfg, t_cfg = _configs("llama3-8b")
    jp = j_jitter_params(j_init_params(jax.random.PRNGKey(4), j_cfg), seed=9)
    j_save_checkpoint(tmp_path / "start", 0, jp,
                      opt_state=j_init_opt_state(jp),
                      extra={"pipeline": {"step": 0}})
    for who in ("jax", "torch"):
        shutil.copytree(tmp_path / "start", tmp_path / who)
    tc = dict(total_steps=2, checkpoint_every=100, log_every=100)
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
        == [1, 2]
    _rel_close([l for _, l in t_tr.history], [l for _, l in j_tr.history])
    for mine, ref in (
            (t_tr.params, j_tr.params), (t_tr.opt_state.mu, j_tr.opt_state.mu),
            (t_tr.opt_state.nu, j_tr.opt_state.nu)):
        got = jax.tree.leaves(params_to_numpy(
            map_tree(lambda t: t.detach(), mine), t_cfg))
        for a, b in zip(got, jax.tree.leaves(ref)):
            _rel_close(a, b, 1e-4)


def test_cached_codes_are_refused_under_grad():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 4, 32)).astype(np.float32))
    scale = torch.zeros(32)
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    cached = L.quantize_channelwise(w)
    with torch.no_grad():          # serving: the cached pair is fine
        want = L.fused_norm_matmul(x, scale, w, w8=1)
        assert torch.equal(L.fused_norm_matmul(x, scale, cached, w8=1), want)
    with pytest.raises(ValueError, match="serving"):
        L.fused_norm_matmul(x.requires_grad_(True), scale, cached, w8=1)
    y = L.fused_norm_matmul(x, scale, w.requires_grad_(True), w8=1)
    assert torch.equal(y.detach(), want)
    gx, gw = torch.autograd.grad(y.sum(), (x, w))
    wq = L.dequantize_channelwise(*cached, w.dtype)
    h = L.rms_norm(x.detach(), scale)
    assert torch.allclose(gx, torch.autograd.grad(
        (L.rms_norm(x, scale) @ wq).sum(), x)[0])
    assert torch.allclose(gw, h.reshape(-1, 32).T @ torch.ones(4, 16))


def test_launcher_trains_a_w8_config(tmp_path, monkeypatch):
    """A quantized config reaches the trainer through its ModelConfig (the
    launcher has no quant flag, as the reference's)."""
    base = launch_train.get_config

    def w8_config(arch):
        return dataclasses.replace(base(arch), quant="w8")

    monkeypatch.setattr(launch_train, "get_config", w8_config)
    assert launch_train.main(["--arch", "llama3-8b", "--smoke", "--device",
                              "cpu", "--steps", "2", "--seq-len", "32",
                              "--batch", "2", "--ckpt", str(tmp_path),
                              "--fused"]) == 0
