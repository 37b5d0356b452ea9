"""The plain offset flash attention (K2's plain version, which
``chip_smoke.py`` holds the bf16 tensor-core kernel to on the card) against
the interpret-mode Pallas ``_flash_kernel_offset`` at the tensor-core
kernel's 64-row and 64-key tile edges."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_attention_2d as j_flash_2d
from repro_torch.kernels import ref


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq", [1, 37, 64, 128])
@pytest.mark.parametrize("q_offset", [0, 63, 64, 65, 896])
def test_plain_offset_flash_matches_pallas_at_tile_edges(q_offset, sq, d):
    """The plain offset branch the card's K2 is held to, against the
    interpret-mode Pallas ``_flash_kernel_offset`` at the tensor-core
    kernel's 64-row and 64-key tile edges (a chunk of ``sq`` rows at
    ``q_offset`` over the gathered extent, 5 positions past kv_len), GQA
    group 4, float32."""
    rng = np.random.default_rng(q_offset * 1000 + sq * 10 + d)
    n = q_offset + sq
    q = rng.standard_normal((4, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, n + 5, d)).astype(np.float32)
            for _ in range(2))
    got = ref.flash_attention_offset(
        *(torch.from_numpy(a) for a in (q, k, v)), q_offset=q_offset,
        kv_len=n, kv_group=4, block_kv=64)
    want = j_flash_2d(*(jnp.asarray(a) for a in (q, k, v)),
                      q_offset=q_offset, kv_len=n, kv_group=4,
                      scale=1.0 / math.sqrt(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
