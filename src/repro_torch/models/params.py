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

Hybrid stacks (zamba2): every layer is a Mamba2 block (``ln``, ``mamba``)
and one ``shared`` attention+MLP block, a single copy outside ``layers``,
runs after every ``shared_attn_every``-th of them (``params.py:212-213``).
RWKV6 stacks: every layer is ``ln1``, ``ln2`` and the time-mix ``tm`` and
channel-mix ``cm`` subtrees (``params.py:134-165``); no learned positions.
"""

from __future__ import annotations

import functools
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
    init: str = "normal"   # normal | zeros | ones | a_log | dt_bias | decay
    fan_in: Optional[int] = None


def _mat(d_in: int, d_out: int) -> ParamDef:
    return ParamDef((d_in, d_out), "normal", fan_in=d_in)


def _vec(n: int, init: str = "zeros") -> ParamDef:
    return ParamDef((n,), init)


def _norm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """``scale``, plus ``bias`` under LayerNorm (``params.py:64-69``)."""
    out = {"scale": _vec(cfg.d_model)}
    if cfg.norm == "layernorm":
        out["bias"] = _vec(cfg.d_model)
    return out


def _attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The projections (``params.py:75-90``), then the QKV biases ``bq``
    [q_dim], ``bk``/``bv`` [kv_dim] under ``qkv_bias`` and the per-head
    RMSNorm scales ``q_norm``/``k_norm`` [head_dim] under ``qk_norm``, all
    zero-initialised (the norms' gain is ``1 + scale``)."""
    d, dq, dkv, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim_
    out = {"wq": _mat(d, dq), "wk": _mat(d, dkv), "wv": _mat(d, dkv),
           "wo": _mat(dq, d)}
    if cfg.qkv_bias:
        out.update(bq=_vec(dq), bk=_vec(dkv), bv=_vec(dkv))
    if cfg.qk_norm:
        out.update(q_norm=_vec(hd), k_norm=_vec(hd))
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


def _mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """The Mamba2 mixer (``params.py:116-130``): input, gate, B, C and
    step projections, the per-head ``dt_bias``/``a_log``/``d_skip``, the
    depthwise conv [K, d_inner] (fan-in K) and its bias, the output
    projection; the reference's leaf order."""
    d, di = cfg.d_model, cfg.d_inner
    h, n, k = cfg.ssm_heads, cfg.ssm_state, cfg.conv_width
    return {
        "wx": _mat(d, di), "wz": _mat(d, di), "wb": _mat(d, n),
        "wc": _mat(d, n), "wdt": _mat(d, h),
        "dt_bias": ParamDef((h,), "dt_bias"),
        "a_log": ParamDef((h,), "a_log"),
        "d_skip": ParamDef((h,), "ones"),
        "conv_w": ParamDef((k, di), "normal", fan_in=k),
        "conv_b": _vec(di),
        "wout": _mat(di, d),
    }


def _rwkv_defs(cfg: ModelConfig) -> Dict[str, Tree]:
    """The RWKV6 time mix ``tm`` and channel mix ``cm`` (``params.py:134``):
    the token-shift mixes (ones), the r/k/v/g/w projections, the per-head
    decay bias ``w_bias`` [H, N] (``"decay"``), the bonus ``u`` [H, N]
    (zeros) and the output projection; the channel mix's k [D, F], v [F,
    D] and r [D, D]; the reference's leaf order."""
    d, f = cfg.d_model, cfg.d_ff
    h, n = cfg.rwkv_heads, cfg.rwkv_head_dim
    tm = {f"mix_{nm}": _vec(d, "ones") for nm in "rkvgw"}
    tm.update({
        "wr": _mat(d, d), "wk": _mat(d, d), "wv": _mat(d, d),
        "wg": _mat(d, d), "ww": _mat(d, d),
        "w_bias": ParamDef((h, n), "decay"),
        "u": ParamDef((h, n), "zeros"),
        "wo": _mat(d, d),
    })
    cm = {"mix_k": _vec(d, "ones"), "mix_r": _vec(d, "ones"),
          "wk": _mat(d, f), "wv": _mat(f, d), "wr": _mat(d, d)}
    return {"tm": tm, "cm": cm}


def block_defs(cfg: ModelConfig, kind: str) -> Dict[str, Tree]:
    """One layer: an attention layer's ln1, attn (wq/wk/wv/wo, with the
    Qwen biases and qk-norm scales where the config has them), ln2, mlp
    (wg/wu/wd, or the MoE router and expert stacks); a Mamba2 layer's ln
    and mamba (the shared attention block lives outside the layers); an
    RWKV6 layer's ln1, ln2, time mix ``tm`` and channel mix ``cm``."""
    if kind == "rwkv":
        return {"ln1": _norm_defs(cfg), "ln2": _norm_defs(cfg),
                **_rwkv_defs(cfg)}
    if kind in ("mamba", "mamba+shared_attn"):
        return {"ln": _norm_defs(cfg), "mamba": _mamba_defs(cfg)}
    if kind not in ("attn", "local_attn", "global_attn"):
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet")
    if cfg.norm == "layernorm" and cfg.gated_ffn:
        raise NotImplementedError(
            f"{cfg.name!r}: a gated FFN under LayerNorm is not ported yet")
    return {
        "ln1": _norm_defs(cfg),
        "attn": _attn_defs(cfg),
        "ln2": _norm_defs(cfg),
        "mlp": _ffn_defs(cfg),
    }


# The layer kind after which the shared attention+MLP block runs.
SHARED_KIND = "mamba+shared_attn"


POS_EMBED_ROWS = 32_768      # learned-position table (``params.py:194``)


def model_defs(cfg: ModelConfig) -> Dict[str, Tree]:
    vp = padded_vocab(cfg.vocab_size)
    d = cfg.d_model
    defs = {}
    # An encoder with a modality frontend (hubert's frames) never embeds
    # tokens, so it has no ``embed`` (``params.py:190``).
    if cfg.frontend == "none" or not cfg.encoder_only:
        defs["embed"] = ParamDef((vp, d), "normal", fan_in=d)
    if cfg.rope == "none" and not cfg.rwkv:
        defs["pos_embed"] = ParamDef((POS_EMBED_ROWS, d), "normal", fan_in=d)
    defs["layers"] = [block_defs(cfg, cfg.layer_kind(i))
                      for i in range(cfg.num_layers)]
    if cfg.shared_attn_every:      # one copy (``params.py:160``)
        defs["shared"] = block_defs(cfg, "attn")
    defs.update({
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
    and cast to ``dtype`` (default: the compute dtype), zero norm scales,
    the Mamba2 heads' fixed ``a_log`` = log(linspace(1, 16)) and
    ``dt_bias`` = softplus^-1(logspace(1e-3, 1e-1)), and the RWKV6 decay
    bias linspace(-6, -0.5, N) on every head — the reference
    ``_init_leaf`` distributions (its numbers differ: JAX keys and torch
    generators draw different streams)."""
    dev = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)

    def leaf(pd: ParamDef) -> torch.Tensor:
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dtype, device=dev)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dtype, device=dev)
        if pd.init in ("a_log", "dt_bias"):
            h = pd.shape[-1]
            if pd.init == "a_log":
                v = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
            else:
                dt = torch.exp(torch.linspace(math.log(1e-3),
                                              math.log(1e-1), h, device=dev))
                v = torch.log(torch.expm1(dt))
            return v.expand(pd.shape).to(dtype)
        if pd.init == "decay":
            v = torch.linspace(-6.0, -0.5, pd.shape[-1], device=dev)
            return v.expand(pd.shape).contiguous().to(dtype)
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
    is group ``g`` of pattern position ``p``; ``rest`` layers follow), the
    ``shared`` block is carried as its one copy, and float32 leaves are
    cast to the compute dtype once — the cast the reference repeats on
    every call (``_cast_tree``)."""
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
    out = {name: to_t(tree[name]) for name in ("embed", "pos_embed")
           if name in tree}
    out["layers"] = layers
    if "shared" in tree:
        out["shared"] = map_tree(to_t, tree["shared"])
    out.update({"final_norm": map_tree(to_t, tree["final_norm"]),
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
        # A copy also of a CPU tensor: a checkpoint's snapshot must not
        # follow the weights the next step updates in place.
        return t.to("cpu", copy=True).numpy()

    layers = [map_tree(to_np, lp) for lp in params["layers"]]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.num_layers}")
    out = {name: to_np(params[name]) for name in ("embed", "pos_embed")
           if name in params}
    out.update({
        "blocks": tuple(_stack(layers[p:groups * period:period])
                        for p in range(period)) if groups else (),
        "rest": tuple(layers[groups * period:]),
    })
    if "shared" in params:
        out["shared"] = map_tree(to_np, params["shared"])
    out.update({
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

    def block(kind: str, bp: Tree) -> Tree:
        choices = plan.layer(kind)
        new = dict(bp)
        for stage, sub, names in W8_STAGES:
            if sub in bp and getattr(choices, stage).kw.get("w8"):
                new[sub] = {n: (quantize_channelwise(w)
                                if n in names and not isinstance(w, tuple)
                                else w)
                            for n, w in bp[sub].items()}
        return new

    out = {**params, "layers": [block(cfg.layer_kind(i), lp) for i, lp
                                in enumerate(params["layers"])]}
    if "shared" in params:       # the shared block's stages: its kind's
        out["shared"] = block(SHARED_KIND, params["shared"])
    return out


def dequantize_weights(cfg: ModelConfig, params: Tree) -> Tree:
    """The eager w8 reference of a ``quantize_weights`` tree: each (codes,
    scales) pair dequantized back to the compute dtype (the forward value
    of the reference's ``_w8_ste``)."""
    from .layers import dequantize_channelwise
    dtype = compute_dtype(cfg)

    def sub(d):
        return {n: (dequantize_channelwise(*w, dtype)
                    if isinstance(w, tuple) else w) for n, w in d.items()}

    def block(bp):
        return {k: sub(v) if k in ("attn", "mlp") else v
                for k, v in bp.items()}

    out = {**params, "layers": [block(lp) for lp in params["layers"]]}
    if "shared" in params:
        out["shared"] = block(params["shared"])
    return out


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


@functools.lru_cache(maxsize=None)
def attn_pool_indices(cfg: ModelConfig) -> Tuple[Optional[int], ...]:
    """Per layer, the index of its K/V along the pools' leading axis (the
    attention layers in order: zamba2's 9 shared-block applications), or
    None for a layer without attention."""
    out, n = [], 0
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) in ("attn", "local_attn", "global_attn",
                                 SHARED_KIND):
            out.append(n)
            n += 1
        else:
            out.append(None)
    return tuple(out)


def has_kv_pools(cfg: ModelConfig) -> bool:
    """Whether any layer attends, and so caches K/V (not RWKV6)."""
    return any(i is not None for i in attn_pool_indices(cfg))


def attn_cache_defs(cfg: ModelConfig, batch: int,
                    max_len: int) -> Dict[str, CacheDef]:
    """Contiguous K/V leaves, one row per attention layer
    (``attn_pool_indices``): ``[L_attn, B, S, Hkv, hd]`` under "bshd",
    ``[L_attn, B, Hkv, S, hd]`` under "bhsd" (the attention-native order,
    ``params.py:329-337``).  Storage follows the compute dtype, as in the
    reference.  Empty for a stack without attention (RWKV6), which has no
    K/V to pool."""
    if cfg.kv_cache_layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown kv_cache_layout {cfg.kv_cache_layout!r} "
                         "(bshd | bhsd)")
    if not has_kv_pools(cfg):
        return {}
    n = sum(i is not None for i in attn_pool_indices(cfg))
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    if cfg.kv_cache_layout == "bhsd":
        shape = (n, batch, hkv, max_len, hd)
    else:
        shape = (n, batch, max_len, hkv, hd)
    dt = compute_dtype(cfg)
    return {"k": CacheDef(shape, dt), "v": CacheDef(shape, dt)}


def state_cache_defs(cfg: ModelConfig, batch: int) -> Dict[str, CacheDef]:
    """Slot-contiguous recurrent state, one row per layer (every layer of
    a Mamba2 or RWKV6 stack carries it; ``params.py:344-366``).  Mamba2:
    ``ssm`` [L, B, H, P, N] float32 and ``conv`` [L, B, K - 1, d_inner],
    the last K - 1 conv inputs.  RWKV6: ``wkv`` [L, B, H, N, N] float32
    and the carried token-shift rows ``tm_shift`` / ``cm_shift`` [L, B,
    D].  ``conv`` and the shift rows are bfloat16 whatever the compute
    dtype (the reference's ``CacheDef`` default: a float32 model rounds
    them to bf16 when they enter the cache).  Empty for other stacks."""
    lyr = cfg.num_layers
    if cfg.rwkv:
        h, n, d = cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
        return {"wkv": CacheDef((lyr, batch, h, n, n), torch.float32),
                "tm_shift": CacheDef((lyr, batch, d), torch.bfloat16),
                "cm_shift": CacheDef((lyr, batch, d), torch.bfloat16)}
    if not cfg.is_mamba:
        return {}
    h = cfg.ssm_heads
    return {"ssm": CacheDef((lyr, batch, h, cfg.ssm_head_dim, cfg.ssm_state),
                            torch.float32),
            "conv": CacheDef((lyr, batch, cfg.conv_width - 1, cfg.d_inner),
                             torch.bfloat16)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The contiguous slot cache (``params.py:395``): zeroed K/V leaves
    (``attn_cache_defs``, ``batch`` rows of ``max_len`` positions in the
    config's layout) and the recurrent state rows (``state_cache_defs``),
    on ``device``."""
    dev = resolve_device(device)
    defs = {**attn_cache_defs(cfg, batch, max_len),
            **state_cache_defs(cfg, batch)}
    return {name: torch.zeros(cd.shape, dtype=cd.dtype, device=dev)
            for name, cd in defs.items()}


def abstract_params(cfg: ModelConfig) -> Tree:
    """The parameter tree as float32 tensors on the ``meta`` device: the
    reference's ``abstract_params`` (``params.py:261``, float32 master
    leaves), shapes and dtypes without storage."""
    return map_tree(lambda pd: torch.empty(pd.shape, dtype=torch.float32,
                                           device="meta"), model_defs(cfg))


def abstract_cache(cfg: ModelConfig, batch: int,
                   max_len: int) -> Dict[str, torch.Tensor]:
    """``init_cache``'s leaves on the ``meta`` device (the reference's
    ``abstract_cache``, ``params.py:402``)."""
    defs = {**attn_cache_defs(cfg, batch, max_len),
            **state_cache_defs(cfg, batch)}
    return {name: torch.empty(cd.shape, dtype=cd.dtype, device="meta")
            for name, cd in defs.items()}
