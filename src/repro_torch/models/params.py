"""Parameter and cache schema of the port, mirroring ``repro.models.params``.

Weights keep the reference layout (``x @ W`` with W ``[D_in, D_out]``) and
leaf names (``model_defs``), so a reference tree converts leaf for leaf.
One difference in structure: the reference stacks layers into pattern
groups for ``lax.scan`` (``blocks`` [G, ...] + ``rest``); the port keeps a
plain list ``layers`` of per-layer dicts and loops over it in Python.

* ``init_params`` draws weights on the device from a ``torch.Generator``
  with the reference's distributions (normal scaled by 1/sqrt(fan_in),
  zero norm scales);
* ``params_from_numpy`` bridges a reference tree (nested dicts/tuples of
  numpy arrays) into that layout, cast once to the compute dtype (float32
  master weights for training with ``dtype=torch.float32``), and
  ``params_to_numpy`` writes a port tree (weights, gradients, AdamW
  moments) back into the reference's stacked layout;
* ``quantize_weights`` replaces the weights of the plan's weight-only int8
  stages by their (codes, scales) once per tree, where the reference
  quantizes inside every fused call (the same deterministic codes).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.common import DeviceLike, resolve_device

Tree = Any

VOCAB_PAD = 256


def padded_vocab(v: int) -> int:
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """bfloat16 under a bf16 config, else float32 (the reference ``_c``)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros
    fan_in: Optional[int] = None


def _mat(d_in: int, d_out: int) -> ParamDef:
    return ParamDef((d_in, d_out), "normal", fan_in=d_in)


def _vec(n: int) -> ParamDef:
    return ParamDef((n,), "zeros")


def _norm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """``scale``, plus ``bias`` under LayerNorm (``params.py:64-69``)."""
    out = {"scale": _vec(cfg.d_model)}
    if cfg.norm == "layernorm":
        out["bias"] = _vec(cfg.d_model)
    return out


def _ffn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The MLP, or under MoE the router ``wr`` [D, E] and the expert
    stacks ``wu``/``wg`` [E, D, F], ``wd`` [E, F, D] (``params.py:96``,
    fan-ins D and F, the reference's leaf order)."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.is_moe:
        e = cfg.num_experts
        out = {"wr": _mat(d, e),
               "wu": ParamDef((e, d, f), "normal", fan_in=d),
               "wd": ParamDef((e, f, d), "normal", fan_in=f)}
        if cfg.gated_ffn:
            out["wg"] = ParamDef((e, d, f), "normal", fan_in=d)
        return out
    out = {"wu": _mat(d, f), "wd": _mat(f, d)}
    if cfg.gated_ffn:
        out["wg"] = _mat(d, f)
    return out


def block_defs(cfg: ModelConfig, kind: str) -> Dict[str, Tree]:
    """One attention layer: ln1, attn (wq/wk/wv/wo), ln2, mlp (wg/wu/wd,
    or the MoE router and expert stacks)."""
    if kind not in ("attn", "local_attn", "global_attn"):
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError(
            f"{cfg.name!r}: qkv bias / qk-norm layers are not ported yet")
    if cfg.norm == "layernorm" and cfg.gated_ffn:
        raise NotImplementedError(
            f"{cfg.name!r}: a gated FFN under LayerNorm is not ported yet")
    d, dq, dkv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {
        "ln1": _norm_defs(cfg),
        "attn": {"wq": _mat(d, dq), "wk": _mat(d, dkv), "wv": _mat(d, dkv),
                 "wo": _mat(dq, d)},
        "ln2": _norm_defs(cfg),
        "mlp": _ffn_defs(cfg),
    }


POS_EMBED_ROWS = 32_768      # learned-position table (``params.py:194``)


def model_defs(cfg: ModelConfig) -> Dict[str, Tree]:
    vp = padded_vocab(cfg.vocab_size)
    d = cfg.d_model
    defs = {"embed": ParamDef((vp, d), "normal", fan_in=d)}
    if cfg.rope == "none" and not cfg.rwkv:
        defs["pos_embed"] = ParamDef((POS_EMBED_ROWS, d), "normal", fan_in=d)
    defs.update({
        "layers": [block_defs(cfg, cfg.layer_kind(i))
                   for i in range(cfg.num_layers)],
        "final_norm": _norm_defs(cfg),
        "lm_head": ParamDef((d, vp), "normal", fan_in=d),
    })
    return defs


def map_tree(fn: Callable, tree: Tree) -> Tree:
    """Apply ``fn`` to every leaf of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Tree) -> list:
    """The leaves of a tree, in ``map_tree``'s order."""
    out = []
    map_tree(out.append, tree)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Tree:
    """Random weights drawn on ``device`` from ``generator`` (which must
    live on that device): float32 normal draws scaled by 1/sqrt(fan_in)
    and cast to ``dtype`` (default: the compute dtype), zero norm scales —
    the reference ``_init_leaf`` distributions (its numbers differ: JAX
    keys and torch generators draw different streams)."""
    dev = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)

    def leaf(pd: ParamDef) -> torch.Tensor:
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=dev)
        w = torch.randn(pd.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        w.mul_(1.0 / math.sqrt(pd.fan_in or pd.shape[0]))
        return w.to(dtype)

    return map_tree(leaf, model_defs(cfg))


def params_from_numpy(tree: Tree, cfg: ModelConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Tree:
    """Bridge a reference parameter tree to the port's layout.

    ``tree`` is the reference ``init_params`` output converted leaf by leaf
    to numpy (nested dicts / tuples).  The stacked ``blocks`` [G, ...]
    leaves are unstacked into per-layer tensors (layer ``g * period + p``
    is group ``g`` of pattern position ``p``; ``rest`` layers follow), and
    float32 leaves are cast to the compute dtype once — the cast the
    reference repeats on every call (``_cast_tree``)."""
    dev = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    period = len(cfg.layer_pattern)
    groups = cfg.num_layers // period

    def to_t(a) -> torch.Tensor:
        t = torch.from_numpy(np.array(a, copy=True)).to(dev)
        return t.to(dtype) if t.dtype == torch.float32 else t

    layers = []
    for g in range(groups):
        for p in range(period):
            layers.append(map_tree(lambda a: to_t(np.asarray(a)[g]),
                                   tree["blocks"][p]))
    for rest in tree.get("rest", ()):
        layers.append(map_tree(to_t, rest))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.num_layers}")
    out = {"embed": to_t(tree["embed"])}
    if "pos_embed" in tree:
        out["pos_embed"] = to_t(tree["pos_embed"])
    out.update({"layers": layers,
                "final_norm": map_tree(to_t, tree["final_norm"]),
                "lm_head": to_t(tree["lm_head"])})
    return out


def _stack(trees) -> Tree:
    """Stack the leaves of same-shaped trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def params_to_numpy(params: Tree, cfg: ModelConfig) -> Tree:
    """The inverse of ``params_from_numpy``: a port tree (per-layer list
    ``layers``) as the reference's tree of numpy arrays, layers stacked
    into pattern groups (``blocks``: one dict per pattern position with
    leaves [G, ...]; ``rest``: the remainder layers).  bfloat16 leaves
    come back as float32 (numpy has no bfloat16; the widening is exact)."""
    period = len(cfg.layer_pattern)
    groups = cfg.num_layers // period

    def to_np(t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    layers = [map_tree(to_np, lp) for lp in params["layers"]]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.num_layers}")
    out = {"embed": to_np(params["embed"])}
    if "pos_embed" in params:
        out["pos_embed"] = to_np(params["pos_embed"])
    out.update({
        "blocks": tuple(_stack(layers[p:groups * period:period])
                        for p in range(period)) if groups else (),
        "rest": tuple(layers[groups * period:]),
        "final_norm": map_tree(to_np, params["final_norm"]),
        "lm_head": to_np(params["lm_head"]),
    })
    return out


# The weights each w8 stage of the plan quantizes: (stage, sub-dict, names).
W8_STAGES = (("qkv", "attn", ("wq", "wk", "wv")),
             ("ffn", "mlp", ("wg", "wu", "wd")))


def quantize_weights(cfg: ModelConfig, params: Tree) -> Tree:
    """A tree in which every weight of a stage the kernel plan flags
    ``w8`` is its ``quantize_channelwise`` (int8 codes, float32 scales)
    pair; every other leaf is shared with ``params``.  Unchanged when the
    config has no weight quantization or runs the eager plan (which keeps
    full-precision weights, as the reference's does)."""
    from ..core.stream_plan import plan_for
    from .layers import quantize_channelwise
    plan = plan_for(cfg, 1) if cfg.weight_quant else None
    if plan is None:
        return params
    layers = []
    for i, lp in enumerate(params["layers"]):
        choices = plan.layer(cfg.layer_kind(i))
        new = dict(lp)
        for stage, sub, names in W8_STAGES:
            if getattr(choices, stage).kw.get("w8"):
                new[sub] = {n: (quantize_channelwise(w)
                                if n in names and not isinstance(w, tuple)
                                else w)
                            for n, w in lp[sub].items()}
        layers.append(new)
    return {**params, "layers": layers}


def dequantize_weights(cfg: ModelConfig, params: Tree) -> Tree:
    """The eager w8 reference of a ``quantize_weights`` tree: each (codes,
    scales) pair dequantized back to the compute dtype (the forward value
    of the reference's ``_w8_ste``)."""
    from .layers import dequantize_channelwise
    dtype = compute_dtype(cfg)

    def sub(d):
        return {n: (dequantize_channelwise(*w, dtype)
                    if isinstance(w, tuple) else w) for n, w in d.items()}

    layers = [{k: sub(v) if k in ("attn", "mlp") else v
               for k, v in lp.items()} for lp in params["layers"]]
    return {**params, "layers": layers}


def weight_bytes(params: Tree) -> int:
    """Resident bytes of a parameter tree (codes and scales included)."""
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    map_tree(add, params)
    return total


# --------------------------------------------------------------------- #
# Cache-leaf schema
# --------------------------------------------------------------------- #

KV_CACHE_LEAVES = ("k", "v")                       # carry a sequence axis
STATE_CACHE_LEAVES = ("ssm", "conv", "wkv", "tm_shift", "cm_shift")
SCALE_CACHE_LEAVES = ("k_scale", "v_scale")


def cache_leaf_kind(name: str) -> str:
    """'kv' (paged / sequence-carrying), 'scale' (per-page dequant scales)
    or 'state' (slot-contiguous); an unregistered leaf raises."""
    if name in KV_CACHE_LEAVES:
        return "kv"
    if name in SCALE_CACHE_LEAVES:
        return "scale"
    if name in STATE_CACHE_LEAVES:
        return "state"
    raise ValueError(
        f"unregistered cache leaf {name!r}: add it to KV_CACHE_LEAVES, "
        "SCALE_CACHE_LEAVES or STATE_CACHE_LEAVES in models/params.py")


def kv_seq_axis(layout: str) -> int:
    """Sequence axis of a K/V cache leaf, counted from the end."""
    return -2 if layout == "bhsd" else -3


@dataclass(frozen=True)
class CacheDef:
    shape: Tuple[int, ...]
    dtype: torch.dtype


def attn_cache_defs(cfg: ModelConfig, batch: int,
                    max_len: int) -> Dict[str, CacheDef]:
    """Contiguous K/V leaves ``[L, B, S, Hkv, hd]`` ("bshd").  Storage
    follows the compute dtype, as in the reference (``params.py:329``)."""
    if cfg.kv_cache_layout != "bshd":
        raise NotImplementedError("the 'bhsd' cache layout is not ported yet")
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim_)
    dt = compute_dtype(cfg)
    return {"k": CacheDef(shape, dt), "v": CacheDef(shape, dt)}
