"""Per-chunk attention remat (``remat_attn_chunk``, set by the dry-run's
``--perf``) on the CPU, on attention architectures.

* ``streaming_attention`` and ``local_attention`` over several key chunks:
  with ``remat_chunk`` the output and the gradients of q, k and v equal
  those without it bit for bit (``torch.utils.checkpoint`` recomputes
  each chunk's scores in the same order);
* ``forward_train`` on reduced llama3-8b (global attention) and gemma3-4b
  (sliding window and global layers): the loss and every gradient leaf
  with ``remat_attn_chunk`` equal those without it bit for bit;
* the counted train step: under ``perf`` the count holds the recomputed
  chunks (more FLOPs than without), and its FLOPs are within 10% of the
  reference's ``lower_cell(..., perf=True)`` on a 1 x 1 host mesh with
  ``analyze_hlo`` (``tests/_torch_launch_ref.py``), as every other cell.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_launch_ref import _one_thread, check_cell  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.op_analysis import count_cell
from repro_torch.models import forward_train, layers as L
from repro_torch.models.params import init_params

ARCHS = ("llama3-8b", "gemma3-4b")
# (batch, tokens) of the gradient test: more than one key chunk in every
# attention layer (1024-key chunks for global attention, gemma3's window
# layers chunk at 128).
GRAD_SHAPES = {"llama3-8b": (1, 1100), "gemma3-4b": (2, 300)}


def _qkv(rng, b=2, s=300, hq=4, hkv=2, d=8):
    return [torch.tensor(rng.standard_normal((b, s, h, d)),
                         dtype=torch.float32, requires_grad=True)
            for h in (hq, hkv, hkv)]


def _attn_grads(fn, q, k, v, remat):
    out = fn(q, k, v, remat_chunk=remat)
    grads = torch.autograd.grad((out * out).sum(), (q, k, v))
    return [out.detach(), *grads]


@pytest.mark.parametrize("kind", ["causal", "window", "bidirectional"])
def test_attention_remat_equals_plain(kind):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng)
    if kind == "window":
        def fn(q, k, v, remat_chunk):
            return L.local_attention(q, k, v, window=100,
                                     remat_chunk=remat_chunk)
    else:
        def fn(q, k, v, remat_chunk):
            return L.streaming_attention(q, k, v, causal=kind == "causal",
                                         chunk_size=64,
                                         remat_chunk=remat_chunk)
    plain = _attn_grads(fn, q, k, v, False)
    remat = _attn_grads(fn, q, k, v, True)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_remat_attn_chunk_grads(arch, monkeypatch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    b, s = GRAD_SHAPES[arch]
    rng = np.random.default_rng(11)
    tokens = torch.tensor(rng.integers(1, cfg.vocab_size, (b, s)),
                          dtype=torch.int64)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    base = init_params(cfg, torch.Generator().manual_seed(4), device="cpu",
                       dtype=torch.float32)
    chunks = []
    checkpoint = L.checkpoint

    def counted(*args, **kw):
        chunks.append(1)
        return checkpoint(*args, **kw)

    monkeypatch.setattr(L, "checkpoint", counted)
    got, remat_chunks = {}, {}
    for remat in (False, True):
        chunks.clear()
        params = torch.utils._pytree.tree_map(
            lambda t: t.detach().clone().requires_grad_(True), base)
        rcfg = dataclasses.replace(cfg, remat_attn_chunk=remat)
        loss = forward_train(params, rcfg, batch)
        leaves = torch.utils._pytree.tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        got[remat] = (loss.detach(), grads)
        remat_chunks[remat] = len(chunks)
    # Every attention layer's chunks went through the checkpoint (twice
    # under the layers' own remat), and none without the flag.
    assert remat_chunks[False] == 0
    assert remat_chunks[True] >= 2 * cfg.num_layers
    assert torch.equal(got[False][0], got[True][0])
    assert len(got[False][1]) == len(got[True][1])
    for a, b in zip(got[False][1], got[True][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_perf_train_count_matches_reference(arch):
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("train", 128, 2, "train")
    plain = count_cell(cfg, shape)[0]
    perf = count_cell(cfg, shape, perf=True)[0]
    assert perf.flops > plain.flops
    check_cell(arch, "train", perf=True)
