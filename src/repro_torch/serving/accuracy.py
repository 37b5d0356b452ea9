"""Parameter jitter for parity checks (copy of
``repro.serving.accuracy.jitter_params``; the rest of that module comes
with the quantized-serving slice)."""

from __future__ import annotations

import torch

from ..models.params import Tree, map_tree


def jitter_params(params: Tree, generator: torch.Generator,
                  sigma: float = 0.05) -> Tree:
    """Add ``sigma`` times standard normal noise (float32 draws from
    ``generator``, which must live on the leaves' device) to every floating
    leaf, keeping its dtype.

    ``init_params`` zero-initialises norm scales, which under the raw
    ``layer_norm`` convention (``y * scale + bias``) makes every gpt2 logit
    zero: a fused/eager or port/reference comparison of such a model would
    pass for nothing.  Jittered weights make it real."""

    def leaf(t: torch.Tensor) -> torch.Tensor:
        if not t.is_floating_point():
            return t
        noise = torch.randn(t.shape, generator=generator,
                            dtype=torch.float32, device=t.device)
        return (t.float() + sigma * noise).to(t.dtype)

    return map_tree(leaf, params)
