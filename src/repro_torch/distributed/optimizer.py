"""AdamW as plain functions on tensors, with the reference's math
(``repro/distributed/optimizer.py``): global-norm clipping with ``+1e-9``,
the schedule evaluated at the step before the increment, decoupled weight
decay on every leaf, float32 moments.

``torch.optim.AdamW`` clips and lays out its state differently, so it does
not stand in for this.  Trees are the port's parameter trees (nested dicts
and lists of tensors).  ``adamw_update`` updates the parameters and the
moments in place (the reference returns new trees): at llama3-8b's width
that saves a second copy of the float32 weights and moments.  The mesh
variant (ZeRO-1 moment sharding) waits for the distributed slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple, Union

import torch

from ..models.params import map_tree, tree_leaves

Tree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor           # int32 scalar: updates applied so far
    mu: Tree
    nu: Tree


def init_opt_state(params: Tree) -> OptState:
    """Zero float32 moments beside each leaf, step 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=map_tree(zeros, params), nu=map_tree(zeros, params))


def lr_schedule(cfg: AdamWConfig,
                step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in float32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio
                            + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    return torch.stack([x.float().square().sum()
                        for x in tree_leaves(tree)]).sum().sqrt()


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: OptState
                 ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: (params, state, {"grad_norm", "lr"}).  ``params``
    and ``state``'s moments are updated in place and returned."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, state.step).to(gnorm.device)
    step = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        delta = (m / bc1) / ((v / bc2).sqrt() + cfg.eps) \
            + cfg.weight_decay * p
        p.sub_(lr * delta)
    return params, OptState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
