"""Pass 4 — alias & in-place-write checker over the serving dispatches.

A copy of the reference's ``repro.analysis.effects`` over the port's
``models/layers.DISPATCH_EFFECTS``, ``serving/kv_cache.paged_cache_defs``
(a flat dict of pool leaves, one group) and ``models/params
.cache_leaf_kind``.  The port runs no donated programs: "donated" reads
as "written in place", which makes the same bugs possible.

A small effect system: each serving dispatch (prefill, chunked prefill,
decode, verify) is described by a declarative signature — which buffers
it writes in place, which ops run in order, what each op reads/writes,
and whether a write is page-table-indexed.  This pass interprets those
signatures (plus the pool schema) and statically rejects the aliasing
bugs in-place writes make possible:

  * **donated-read-after-write** — an op reads a donated buffer's
    ORIGINAL contents (``reads_initial``) after an earlier op already
    wrote it; under donation the original storage is gone.
  * **cow-self-alias** — a copy-on-write op whose destination page is
    not guaranteed freshly allocated (``fresh_dst``): dst could alias
    src (self-copy) or a still-shared page (clobbering other slots).
  * **unguarded-null-page** — a page-table-indexed write that doesn't
    route dead/inactive rows onto the sacrificial ``NULL_PAGE``; pad
    lanes would scatter into live pages.
  * **scale-lockstep** — under a KV quant mode, a page-indexed value
    write that doesn't update the per-page scale twins; codes and
    scales would decode against stale statistics.
  * **missing-scale-pool / scale-shape / scale-dtype** — the pool
    schema itself: every quantized K/V pool leaf must carry a
    ``<name>_scale`` sibling of shape [G, num_pages, Hkv] float32
    indexed by the same physical page ids.

Everything here is data-driven so tests can seed bad signatures /
doctored pool trees through the ``signatures=`` / ``cache_defs=``
overrides without touching the shipped declarations.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..configs.base import ModelConfig
from ..core.stream_plan import StreamPlan
from .diagnostics import Diagnostic


def _pool_groups(tree) -> List[Dict[str, Any]]:
    """Flatten a paged cache-def tree into its per-group leaf dicts."""
    if isinstance(tree, dict) and ("blocks" in tree or "rest" in tree):
        groups: List[Dict[str, Any]] = []
        for key in ("blocks", "rest"):
            for g in tree.get(key, ()):
                groups.append(g)
        return groups
    if isinstance(tree, dict):
        return [tree]
    return list(tree)


def _leaf_kind(name: str) -> str:
    from ..models.params import cache_leaf_kind
    try:
        return cache_leaf_kind(name)
    except ValueError:
        return "unknown"


def check_pools(cfg: ModelConfig, cache_defs,
                page_size: int) -> List[Diagnostic]:
    """Schema check over the paged pool tree (no arrays allocated)."""
    diags: List[Diagnostic] = []
    if cache_defs is None:
        return diags
    kv_quant = cfg.kv_quant is not None
    for group in _pool_groups(cache_defs):
        for name, cd in group.items():
            kind = _leaf_kind(name)
            where = f"pool.{name}"
            if kind != "kv":
                continue
            shape = tuple(cd.shape)
            if len(shape) == 5 and shape[2] != page_size:
                diags.append(Diagnostic(
                    "error", "effects", where, "page-granule-mismatch",
                    f"pool {name} has page granule {shape[2]} but the "
                    f"plan streams {page_size}-token pages",
                    "build pools and plan from one page_size"))
            if not kv_quant:
                continue
            twin = group.get(name + "_scale")
            if twin is None:
                diags.append(Diagnostic(
                    "error", "effects", where, "missing-scale-pool",
                    f"kv pool {name} stores quantized codes but has no "
                    f"{name}_scale sibling — pages could never be "
                    "dequantized",
                    "emit the [G, num_pages, Hkv] f32 scale leaf next "
                    "to every quantized pool"))
                continue
            want = (shape[0], shape[1], cfg.num_kv_heads)
            if tuple(twin.shape) != want:
                diags.append(Diagnostic(
                    "error", "effects", where, "scale-shape",
                    f"{name}_scale has shape {tuple(twin.shape)}; the "
                    f"page-id-indexed lockstep layout needs {want}",
                    "index scales by the same (group, page, kv_head) "
                    "ids as the pool"))
            if twin.dtype != torch.float32:
                got = str(twin.dtype).removeprefix("torch.")
                diags.append(Diagnostic(
                    "error", "effects", where, "scale-dtype",
                    f"{name}_scale is {got}; "
                    "per-page scales must be float32",
                    "keep dequant statistics in f32"))
    return diags


def check_signatures(cfg: ModelConfig,
                     signatures: Dict[str, Dict[str, Any]]
                     ) -> List[Diagnostic]:
    """Interpret each dispatch signature, tracking the written set."""
    diags: List[Diagnostic] = []
    kv_quant = cfg.kv_quant is not None
    for sig_name, sig in signatures.items():
        where = f"dispatch.{sig_name}"
        donated = set(sig.get("donated", ()))
        written: set = set()
        for op in sig.get("ops", ()):
            op_name = op.get("name", "?")
            # Original-contents reads of a donated buffer after a write:
            # under donation the pre-dispatch storage no longer exists.
            for buf in op.get("reads_initial", ()):
                if buf in donated and buf in written:
                    diags.append(Diagnostic(
                        "error", "effects", where,
                        "donated-read-after-write",
                        f"op {op_name} reads the original contents of "
                        f"donated buffer {buf!r} after an earlier op "
                        "already wrote it — donation freed that storage",
                        "order the initial-contents read before every "
                        "write, or stop donating the buffer"))
            cow = op.get("cow")
            if cow is not None and not cow.get("fresh_dst", False):
                diags.append(Diagnostic(
                    "error", "effects", where, "cow-self-alias",
                    f"op {op_name} copies page {cow.get('src')!r} onto "
                    f"{cow.get('dst')!r} without a fresh-dst guarantee "
                    "— dst may alias src or a still-shared page",
                    "allocate cow_dst fresh (refs == 1) before the "
                    "divergent write (kv_cache.POOL_INVARIANTS)"))
            if op.get("page_indexed"):
                if not op.get("null_routed", False):
                    diags.append(Diagnostic(
                        "error", "effects", where, "unguarded-null-page",
                        f"op {op_name} scatters by page id without "
                        "routing dead rows onto NULL_PAGE — pad lanes "
                        "would corrupt live pages",
                        "mask inactive rows to the sacrificial page 0"))
                if kv_quant and not op.get("updates_scales", False):
                    diags.append(Diagnostic(
                        "error", "effects", where, "scale-lockstep",
                        f"op {op_name} writes quantized pages but not "
                        "their per-page scale twins — codes would "
                        "decode against stale scales",
                        "update <pool>_scale in the same dispatch as "
                        "the pool write"))
            written |= set(op.get("writes", ()))
    return diags


def check_effects(plan: StreamPlan, cfg: ModelConfig, *,
                  slots: Optional[int] = None,
                  max_len: Optional[int] = None,
                  page_size: Optional[int] = None,
                  signatures: Optional[Dict[str, Dict[str, Any]]] = None,
                  cache_defs=None) -> List[Diagnostic]:
    """Run the effect system over the dispatch signatures + pool schema.

    ``signatures`` defaults to the shipped ``DISPATCH_EFFECTS``;
    ``cache_defs`` defaults to the schema ``paged_cache_defs`` would
    build for (slots, max_len, page_size) when those are given.  Both
    are overridable so tests can seed bad fixtures.
    """
    ps = page_size or plan.decode_page_size()
    if signatures is None:
        from ..models.layers import DISPATCH_EFFECTS
        signatures = DISPATCH_EFFECTS
    if cache_defs is None and slots is not None and max_len is not None:
        from ..serving.kv_cache import paged_cache_defs
        cache_defs = paged_cache_defs(cfg, slots, max_len, ps)
    diags = check_pools(cfg, cache_defs, ps)
    diags += check_signatures(cfg, signatures)
    return diags
