"""Step functions of one device (``repro/distributed/steps.py``): train,
prefill and decode, their abstract inputs, and ``trace_cell``, which the
dry-run counts.

The train step is the gradient of ``forward_train`` by autograd, then
``adamw_update``.  The abstract inputs are tensors on the ``meta``
device with the reference's keys, shapes and dtypes (its
``ShapeDtypeStruct`` stand-ins).  The mesh variants (tensor and data
parallelism, the ``embed``/``sp`` activation pins) come with the
distributed slice (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..kernels.common import DeviceLike, resolve_device
from ..models import decode_step, forward_train, prefill
from ..models.model import _cast_tree
from ..models.params import (abstract_cache, abstract_params, map_tree,
                             tree_leaves)
from .optimizer import AdamWConfig, OptState, adamw_update

Tree = Any
Batch = Dict[str, Any]


# --------------------------------------------------------------------- #
# Abstract inputs (the dry-run's stand-ins, ``steps.py:35-68``)
# --------------------------------------------------------------------- #

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_abstract(cfg: ModelConfig, shape: ShapeConfig) -> Batch:
    """``tokens`` (or a frontend's bf16 ``embeds``), ``labels`` and under
    M-RoPE ``positions`` [3, B, S]."""
    b, s = shape.global_batch, shape.seq_len
    out: Batch = {}
    if cfg.frontend != "none":
        out["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    out["labels"] = _meta((b, s), torch.int32)
    if cfg.rope == "mrope":
        out["positions"] = _meta((3, b, s), torch.int32)
    return out


def decode_inputs_abstract(cfg: ModelConfig, shape: ShapeConfig) -> Batch:
    """One new token per sequence against a contiguous cache of
    ``shape.seq_len`` positions; ``cache_pos`` the scalar write position."""
    b = shape.global_batch
    return {"tokens": _meta((b, 1), torch.int32),
            "cache": abstract_cache(cfg, b, shape.seq_len),
            "cache_pos": _meta((), torch.int32),
            "lengths": _meta((b,), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Batch:
    """Every model input of one dry-run cell, as meta tensors."""
    if shape.kind == "decode":
        return decode_inputs_abstract(cfg, shape)
    return train_batch_abstract(cfg, shape)


def abstract_opt_state(params: Tree) -> OptState:
    """AdamW's state beside abstract parameters: float32 moments and the
    int32 step (``optimizer.py:47``)."""
    def zeros(p):
        return _meta(p.shape, torch.float32)
    return OptState(step=_meta((), torch.int32), mu=map_tree(zeros, params),
                    nu=map_tree(zeros, params))


# --------------------------------------------------------------------- #
# Train step (``steps.py:71``)
# --------------------------------------------------------------------- #

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


# --------------------------------------------------------------------- #
# Prefill / decode steps (``steps.py:135``, ``:153``)
# --------------------------------------------------------------------- #

def make_prefill_step(cfg: ModelConfig, device: DeviceLike = None
                      ) -> Callable[[Tree, Batch], Tuple[torch.Tensor, Tree]]:
    """``fn(params, batch) -> (logits [B, 1, Vp], cache)``: the whole-prompt
    forward pass on ``device`` (None: the card).  ``batch`` holds
    ``tokens`` [B, S] or a frontend's ``embeds`` (and M-RoPE
    ``positions``); a ``labels`` entry is ignored.  float32 leaves of
    ``params`` are cast to the compute dtype at each call, as the
    reference's ``prefill`` does."""
    dev = resolve_device(device)

    @torch.no_grad()
    def fn(params: Tree, batch: Batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        return prefill(_cast_tree(cfg, params), cfg, batch.get("tokens"),
                       embeds=batch.get("embeds"),
                       positions=batch.get("positions"))

    return fn


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                     device: DeviceLike = None
                     ) -> Callable[..., Tuple[torch.Tensor, Tree]]:
    """serve_step: ``fn(params, tokens, cache, cache_pos, lengths) ->
    (next_tokens [B, 1], cache)``, one new token per sequence against the
    contiguous cache of ``shape`` (``shape.global_batch`` rows of
    ``shape.seq_len`` positions, ``decode_inputs_abstract``), updated in
    place, on ``device`` (None: the card).  ``cache_pos`` is a scalar or
    per-row write position; params as ``make_prefill_step``."""
    dev = resolve_device(device)
    want = {name: tuple(t.shape) for name, t in
            abstract_cache(cfg, shape.global_batch, shape.seq_len).items()}

    @torch.no_grad()
    def fn(params: Tree, tokens, cache: Dict[str, torch.Tensor], cache_pos,
           lengths):
        got = {name: tuple(t.shape) for name, t in cache.items()}
        if got != want:
            raise ValueError(f"cache {got} is not the {shape.name} cell's "
                             f"{want}")
        tokens = torch.as_tensor(tokens).to(dev)
        b = tokens.shape[0]
        pos = torch.as_tensor(cache_pos, dtype=torch.int32).to(dev)
        nt, _, cache = decode_step(_cast_tree(cfg, params), cfg, tokens,
                                   cache, pos.reshape(-1).expand(b),
                                   torch.as_tensor(lengths).to(dev))
        return nt, cache

    return fn


# --------------------------------------------------------------------- #
# One dry-run cell (``steps.py:180``, ``lower_cell``)
# --------------------------------------------------------------------- #

PERF_MODES = (False, True, "all", "embed", "sp")


def perf_config(cfg: ModelConfig, perf: object = False) -> ModelConfig:
    """The config a cell runs: ``perf`` False is the paper-faithful
    baseline; True/"all" applies the reference's optimization set
    (``steps.py:189-192``: chunked wkv6, per-chunk attention remat, the
    attention-native cache layout).  The ``embed``/``sp`` pin modes are
    sharding constraints on a mesh."""
    if perf not in PERF_MODES:
        raise ValueError(f"unknown perf mode {perf!r} (have {PERF_MODES})")
    if perf in ("embed", "sp"):
        raise NotImplementedError(
            f"perf pin mode {perf!r}: activation sharding constraints need "
            "the mesh steps, not ported yet (ROADMAP queue 1 item 10)")
    if not perf:
        return cfg
    return replace(cfg, rwkv_chunk=16, remat_attn_chunk=True,
                   kv_cache_layout="bhsd")


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, perf: object = False,
               *, remat: bool = True, device: DeviceLike = None
               ) -> Tuple[Callable, tuple]:
    """The step function of one (arch x shape) cell on ``device`` (None:
    the card) and its inputs as meta tensors: ``(fn, args)``, with
    ``fn(*args)`` one step.  train: ``(params, opt_state, batch)``
    (float32 masters, AdamW moments); prefill: ``(params, batch)``
    without labels; decode: ``(params, tokens, cache, cache_pos,
    lengths)``.  ``perf``: ``perf_config``."""
    cfg = perf_config(cfg, perf)
    params = abstract_params(cfg)
    if shape.kind == "train":
        return (make_train_step(cfg, remat=remat, device=device),
                (params, abstract_opt_state(params),
                 train_batch_abstract(cfg, shape)))
    if shape.kind == "prefill":
        batch = train_batch_abstract(cfg, shape)
        batch.pop("labels")
        return make_prefill_step(cfg, device=device), (params, batch)
    if shape.kind != "decode":
        raise ValueError(f"unknown cell kind {shape.kind!r}")
    inputs = decode_inputs_abstract(cfg, shape)
    return (make_decode_step(cfg, shape, device=device),
            (params, inputs["tokens"], inputs["cache"], inputs["cache_pos"],
             inputs["lengths"]))
