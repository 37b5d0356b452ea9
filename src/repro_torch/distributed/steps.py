"""The train step (``repro/distributed/steps.py:71``), single device: the
gradient of ``forward_train`` by autograd, then ``adamw_update``.  The
mesh variant (tensor and data parallelism) comes with the distributed
slice."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.common import DeviceLike, resolve_device
from ..models import forward_train
from ..models.params import map_tree, tree_leaves
from .optimizer import AdamWConfig, OptState, adamw_update

Tree = Any
Batch = Dict[str, Any]


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    remat: bool = True, device: DeviceLike = None
                    ) -> Callable[[Tree, OptState, Batch],
                                  Tuple[Tree, OptState,
                                        Dict[str, torch.Tensor]]]:
    """``step_fn(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})`` on ``device`` (None: the card).
    ``params`` are float32 master weights (``init_params(...,
    dtype=torch.float32)``), updated in place; ``batch`` holds ``tokens``
    and ``labels`` [B, S] (numpy or tensors), -100 = ignore, or a
    frontend's ``embeds`` (and M-RoPE ``positions``) in place of the
    tokens."""
    opt_cfg = opt_cfg or AdamWConfig()
    dev = resolve_device(device)

    def step_fn(params: Tree, opt_state: OptState, batch: Batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = forward_train(params, cfg, batch, remat=remat)
            # A leaf the loss does not read (the token embedding under a
            # frontend's ``embeds``) gets a zero gradient, as under
            # ``jax.grad``.
            flat = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True))
        grads = map_tree(lambda _: next(flat), params)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        return params, opt_state, {"loss": loss.detach(), **metrics}

    return step_fn
