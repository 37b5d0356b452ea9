"""Pass 1 — itensor reconstruction + fusion legality (paper §3.1).

A copy of the reference's ``repro.analysis.itensor_check`` over the
port's ``core.itensor``, ``core.converter`` and ``kernels.common``.  Every
fused ``KernelChoice`` implies an iterative-tensor type: the block
targets are the ``elem_shape``, the grid over the stage's data extents is
the ``tripcounts`` (the type-level twin of the block schedule the
reference's kernels run and the plain versions walk).  This pass rebuilds
those types from
the plan ALONE (no kernel is traced) and checks, for every adjacent
fused stage pair sharing the token stream, what fusing them actually
costs the way ``core/converter.py`` would:

  * ``match``       — identical stream layout; a raw FIFO fuses them.
  * ``regranulate`` — same element order, one token granule divides the
    other; a FIFO re-blocks for free (Algorithm 1's full-window answer
    is conservative here, so we refine it).
  * ``converter``   — a bounded ping-pong window re-orders the stream;
    reported with its analytic byte cost.
  * ``rebuffer``    — no shared loop prefix: the "fusion" silently
    materializes the whole intermediate tensor.  Flagged (warning when
    the ping-pong window exceeds the platform's fusion budget, info
    otherwise — small full windows are how the serving plan's tiny
    slot-count streams legitimately look).

The reconstruction itself is exposed (``stage_itensors``) so tests can
assert elem_shape == blocks and grid_shape == the stage grid.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..configs.base import ModelConfig
from ..core.converter import fusion_verdict, infer_converter
from ..core.itensor import ITensorType, itensor_from_tiling
from ..core.stream_plan import KernelChoice, StreamPlan
from ..kernels.common import pick_block
from .diagnostics import Diagnostic

# Token-dim block target per stage (the dim adjacent stages stream over).
_TOKEN_BLOCK = {"qkv": "block_t", "attention": "block_q", "ffn": "block_t",
                "mixer": "chunk", "lm_head": "block_t"}


def _feature_extents(cfg: ModelConfig, kind: str, stage: str,
                     choice: KernelChoice) -> List[Tuple[str, int]]:
    """(block_name, data extent) pairs for a stage's non-token dims."""
    if stage == "qkv":
        return [("block_n", min(cfg.q_dim, cfg.kv_dim))]
    if stage == "attention":
        return [("block_kv", 0)]        # extent filled in from kv_len
    if stage == "ffn":
        if choice.implementation == "moe_experts":
            return []
        return [("block_f", cfg.d_ff)]
    if stage == "lm_head":
        return [("block_v", cfg.vocab_size)]
    return []


def stage_itensor(cfg: ModelConfig, plan: StreamPlan, kind: str,
                  stage: str, choice: KernelChoice
                  ) -> Optional[ITensorType]:
    """Reconstruct one fused stage's OUTPUT/iteration itensor type from
    its block targets.  ``None`` for eager stages and the paged decode /
    verify twins (their stream is the page stream, checked in pass 2)."""
    if not choice.fused or stage in ("decode_attn", "verify_attn"):
        return None
    tokens = plan.tokens
    tname = _TOKEN_BLOCK.get(stage)
    tt = pick_block(tokens, choice.block(tname, tokens) or tokens)
    feats = _feature_extents(cfg, kind, stage, choice)
    if stage == "attention":
        feats = [("block_kv", plan.kv_len)]
    dims: List[int] = [tokens]
    tiles: List[int] = [tt]
    for bname, extent in feats:
        if extent <= 0:
            continue
        dims.append(extent)
        tiles.append(pick_block(extent, choice.block(bname, extent)
                                or extent))
    return itensor_from_tiling(tuple(dims), tuple(tiles), dtype=cfg.dtype)


def stage_itensors(plan: StreamPlan, cfg: ModelConfig
                   ) -> Dict[Tuple[str, str], ITensorType]:
    """Every fused stage's reconstructed itensor, keyed (owner, stage)."""
    out: Dict[Tuple[str, str], ITensorType] = {}
    for kind, stage, choice in plan.stage_choices():
        t = stage_itensor(cfg, plan, kind, stage, choice)
        if t is not None:
            out[(kind, stage)] = t
    return out


def _token_stream(plan: StreamPlan, stage: str,
                  choice: KernelChoice, dtype: str) -> ITensorType:
    """The 1-D token-stream type a stage produces/consumes."""
    tokens = plan.tokens
    tname = _TOKEN_BLOCK.get(stage, "block_t")
    tile = pick_block(tokens, choice.block(tname, tokens) or tokens)
    return itensor_from_tiling((tokens,), (tile,), dtype=dtype)


def _pair_verdict(src: ITensorType, res: ITensorType) -> str:
    """``fusion_verdict`` refined for same-order re-granulation."""
    v = fusion_verdict(src, res)
    if v != "rebuffer":
        return v
    # 1-D exact tilings stream elements in identical (row-major) order;
    # when one granule divides the other a FIFO re-blocks without any
    # window — Algorithm 1's full-extent answer is conservative there.
    if (src.rank == 1 and res.rank == 1
            and src.is_exact_tiling() and res.is_exact_tiling()):
        a, b = src.elem_shape[0], res.elem_shape[0]
        if max(a, b) % min(a, b) == 0:
            return "regranulate"
    return v


def check_itensors(plan: StreamPlan, cfg: ModelConfig,
                   fusion_budget: float) -> List[Diagnostic]:
    diags: List[Diagnostic] = []

    # Reconstruction sanity: every fused stage must admit an exact tiling
    # at its effective blocks (pick_block guarantees this for plans
    # build_stream_plan emitted; a hand-edited plan can violate it).
    for kind, stage, choice in plan.stage_choices():
        try:
            stage_itensor(cfg, plan, kind, stage, choice)
        except ValueError as e:
            diags.append(Diagnostic(
                "error", "itensor", f"{kind}.{stage}", "no-exact-tiling",
                f"cannot reconstruct an itensor for "
                f"{choice.implementation}: {e}",
                "use block targets whose pick_block clip divides the "
                "stage extents"))

    # Producer/consumer compatibility over the shared token stream, per
    # layer-kind pipeline (qkv -> attention -> ffn, wrapping to the next
    # layer), then the last stage into the LM head.
    for kind, lp in plan.layers:
        chain = [(s, c) for s, c in lp.stages()
                 if c.fused and s in ("qkv", "attention", "ffn", "mixer")]
        pairs = list(zip(chain, chain[1:]))
        if len(chain) > 1:
            pairs.append((chain[-1], chain[0]))       # layer l -> l+1
        if chain and plan.lm_head.fused:
            pairs.append((chain[-1], ("lm_head", plan.lm_head)))
        for (ps, pc), (cs, cc) in pairs:
            owner = kind if cs != "lm_head" else "final"
            src = _token_stream(plan, ps, pc, cfg.dtype)
            res = _token_stream(plan, cs, cc, cfg.dtype)
            v = _pair_verdict(src, res)
            if v in ("match", "regranulate"):
                continue
            if v == "incompatible":
                diags.append(Diagnostic(
                    "error", "itensor", f"{owner}.{cs}",
                    "incompatible-stream",
                    f"{kind}.{ps} streams {src} but {cs} consumes {res}: "
                    "no converter exists (different data space/dtype)",
                    "make producer and consumer agree on the token "
                    "stream's data space and dtype"))
                continue
            spec = infer_converter(src, res)
            cost = spec.pingpong_bytes if spec else 0.0
            if v == "rebuffer":
                sev = "warning" if cost > fusion_budget else "info"
                diags.append(Diagnostic(
                    sev, "itensor", f"{owner}.{cs}", "full-rebuffer",
                    f"fusing {kind}.{ps} (tile {src.elem_shape[0]}) into "
                    f"{cs} (tile {res.elem_shape[0]}) silently rebuffers "
                    f"the full token stream ({cost:.0f} B ping-pong)",
                    f"align the {_TOKEN_BLOCK.get(ps)} / "
                    f"{_TOKEN_BLOCK.get(cs, 'block_t')} targets so one "
                    "granule divides the other"))
            else:   # bounded converter
                diags.append(Diagnostic(
                    "info", "itensor", f"{owner}.{cs}", "layout-converter",
                    f"{kind}.{ps} -> {cs} needs a stream-layout converter "
                    f"({cost:.0f} B ping-pong window)"))
    return diags
