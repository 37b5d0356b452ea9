"""K11, the streamed cross-entropy, on the CPU: the port's plain version
against the reference Pallas kernel (interpret mode) on the same
numpy-seeded float32 inputs, and the port's ``fused_streamed_xent``
autograd wrapper against the reference wrapper's ``jax.vjp``.

Tolerances are relative (max |diff| over max |ref|) at 1e-5: the two sum
the logits in different orders.  The CUDA kernel runs only on the card;
``chip_smoke.py`` holds it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import streamed_xent_loss as j_xent_loss
from repro.kernels import streamed_xent_parts as j_xent_parts
from repro.models import layers as JL
from repro_torch import kernels as K
from repro_torch.kernels.streamed_xent import vocab_split
from repro_torch.models import layers as L

REL = 1e-5


def _rel_close(got, want, tol=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _inputs(t, d, vp, vocab, seed=7, ignore=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((t, d)).astype(np.float32)
    head = (0.1 * rng.standard_normal((d, vp))).astype(np.float32)
    labels = rng.integers(0, vocab, t).astype(np.int32)
    labels[rng.permutation(t)[:ignore]] = -100
    return hidden, head, labels


# (T, D, Vp, vocab): the reference's own kernel-test shapes
# (tests/test_kernels.py:124), and a vocab that is not a multiple of 256
# with one tile of padding columns (reduced configs have vocab 256 = Vp and
# never reach the pad mask).
SHAPES = [(32, 64, 256, 200), (64, 32, 512, 512), (48, 64, 256, 131)]


@pytest.mark.parametrize("t,d,vp,vocab", SHAPES)
def test_parts_match_pallas(t, d, vp, vocab):
    hidden, head, labels = _inputs(t, d, vp, vocab)
    lse, gold = K.streamed_xent_parts(torch.from_numpy(hidden),
                                      torch.from_numpy(head),
                                      torch.from_numpy(labels),
                                      vocab_size=vocab)
    j_lse, j_gold = j_xent_parts(jnp.asarray(hidden), jnp.asarray(head),
                                 jnp.asarray(labels), vocab_size=vocab,
                                 block_t=16, block_v=64)
    assert lse.dtype == gold.dtype == torch.float32
    _rel_close(lse.numpy(), j_lse)
    _rel_close(gold.numpy(), j_gold)


@pytest.mark.parametrize("t,d,vp,vocab", SHAPES)
def test_loss_with_ignored_labels_matches_pallas(t, d, vp, vocab):
    hidden, head, labels = _inputs(t, d, vp, vocab, seed=3, ignore=t // 4)
    got = K.streamed_xent_loss(torch.from_numpy(hidden),
                               torch.from_numpy(head),
                               torch.from_numpy(labels), vocab_size=vocab)
    want = j_xent_loss(jnp.asarray(hidden), jnp.asarray(head),
                       jnp.asarray(labels), vocab_size=vocab, block_t=16,
                       block_v=64)
    _rel_close(got.numpy(), want)
    # Every label ignored: the mean over no token is 0, as in the reference.
    none = np.full_like(labels, -100)
    assert float(K.streamed_xent_loss(
        torch.from_numpy(hidden), torch.from_numpy(head),
        torch.from_numpy(none), vocab_size=vocab)) == 0.0


def test_labels_past_the_vocab_find_the_mask():
    """A label in the padding columns reads the masked logit (-1e30), as
    the Pallas kernel's hit does."""
    hidden, head, labels = _inputs(16, 32, 256, 200)
    labels[:3] = [200, 230, 255]
    _, gold = K.streamed_xent_parts(torch.from_numpy(hidden),
                                    torch.from_numpy(head),
                                    torch.from_numpy(labels),
                                    vocab_size=200)
    _, j_gold = j_xent_parts(jnp.asarray(hidden), jnp.asarray(head),
                             jnp.asarray(labels), vocab_size=200,
                             block_t=16, block_v=64)
    np.testing.assert_array_equal(gold[:3].numpy(),
                                  np.full(3, -1e30, np.float32))
    np.testing.assert_array_equal(np.asarray(j_gold)[:3],
                                  np.full(3, -1e30, np.float32))
    _rel_close(gold[3:].numpy(), np.asarray(j_gold)[3:])


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    hidden, head, labels = _inputs(16, 32, 256, 200)
    K.reset_launches()
    K.streamed_xent_parts(torch.from_numpy(hidden), torch.from_numpy(head),
                          torch.from_numpy(labels), vocab_size=200)
    assert K.launch_counts()["streamed_xent"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        K.streamed_xent_parts(torch.empty(16, 32, device="meta"),
                              torch.empty(32, 256, device="meta"),
                              torch.empty(16, dtype=torch.int32,
                                          device="meta"), vocab_size=200)
    with pytest.raises(ValueError, match="streamed_xent"):
        K.streamed_xent_parts(torch.zeros(16, 32), torch.zeros(31, 256),
                              torch.zeros(16, dtype=torch.int32),
                              vocab_size=200)


def test_vocab_split_covers_every_tile_once():
    """The CUDA kernel's vocab ranges: contiguous, non-empty, covering every
    64-column tile, about four blocks per SM over the token tiles."""
    for t, vp in ((8192, 50432), (4096, 128256), (64, 256), (8, 64)):
        per, splits = vocab_split(t, vp, 132)
        tiles = -(-vp // 64)
        assert per >= 1 and (splits - 1) * per < tiles <= splits * per
    assert vocab_split(8192, 50432, 132) == (158, 5)
    assert vocab_split(4096, 128256, 132) == (223, 9)


def _xent_case(seed=5):
    """[B, S, D] hidden, a [D, Vp] head with padding columns and labels
    with ignored positions, as ``forward_train`` passes them."""
    rng = np.random.default_rng(seed)
    b, s, d, vp, vocab = 2, 24, 32, 256, 200
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    head = (0.1 * rng.standard_normal((d, vp))).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[0, :5] = -100
    return hidden, head, labels, vocab


def test_fused_streamed_xent_grads_are_the_eager_grads():
    """The wrapper's backward is the eager formulation's autograd, bit for
    bit, and matches ``jax.vjp`` of the reference wrapper at 1e-5."""
    hidden, head, labels, vocab = _xent_case()
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(head).requires_grad_(True)
    y = torch.from_numpy(labels)
    loss = L.fused_streamed_xent(h, w, y, vocab)
    got = torch.autograd.grad(loss, (h, w))

    h2 = torch.from_numpy(hidden).requires_grad_(True)
    w2 = torch.from_numpy(head).requires_grad_(True)
    logits = (h2.reshape(-1, h2.shape[-1]) @ w2).float()
    logits = logits.masked_fill(torch.arange(logits.shape[-1]) >= vocab,
                                -1e30)
    yf = y.reshape(-1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, torch.clamp(yf, min=0).long()[:, None])
    valid = yf >= 0
    eager = (torch.where(valid, lse - gold[:, 0], 0.0).sum()
             / torch.clamp(valid.sum(), min=1))
    want = torch.autograd.grad(eager, (h2, w2))
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    j_loss, vjp = jax.vjp(
        lambda a, b: JL.fused_streamed_xent(a, b, jnp.asarray(labels), vocab,
                                            block_t=16, block_v=64),
        jnp.asarray(hidden), jnp.asarray(head))
    _rel_close(loss.detach().numpy(), j_loss)
    for a, b in zip(got, vjp(jnp.ones((), jnp.float32))):
        _rel_close(a.numpy(), b)


def test_fused_streamed_xent_without_grad_builds_no_node():
    hidden, head, labels, vocab = _xent_case()
    h = torch.from_numpy(hidden).requires_grad_(True)
    with torch.no_grad():
        loss = L.fused_streamed_xent(h, torch.from_numpy(head),
                                     torch.from_numpy(labels), vocab)
    assert loss.grad_fn is None and not loss.requires_grad
