"""StreamPlan: the compiler-to-runtime bridge (DSE decisions drive execution).

A copy of the reference's ``repro.core.stream_plan`` with the port's
kernels behind it.  Everything upstream of this module is analysis:
``trace.py`` turns a ``ModelConfig`` block into structured ops,
``tiling.py``/``dse.py`` explore tile sizes and unroll with fusion
feedback, ``fusion.py`` groups kernels under the on-chip budget, and
``lowering.py`` names a kernel module per fusion group.
``build_stream_plan`` runs that pipeline for a ``Platform`` (``H100`` by
default, the card the port's kernels run on) and emits, per layer kind
(attn / local_attn / mamba / rwkv / ...), the kernel choice and block
sizes the model runs; ``models/model.py`` resolves it at every entry
point and dispatches the stages it marks fused to the Hopper kernels of
``repro_torch.kernels``.  ``plan_for`` is that build, cached.

Stage mapping (as the reference's):

  * ``qkv``: ln1 + Q/K/V projections.  ``rmsnorm_matmul`` when the fusion
    pass put ``ln1`` and ``q_proj`` in one group and the norm is RMSNorm;
    ``block_matmul`` when only the projections fused; eager otherwise.
  * ``attention``: the composite attention op, ``flash_attention`` when its
    group lowered to a kernel pattern.
  * ``decode_attn`` / ``verify_attn``: single-token and speculative-window
    attention over the paged KV cache (``paged_attention`` /
    ``verify_attention``) whenever attention fused; their page size is
    the raw DSE tile of the attention op's KV dim (pages are streaming
    granules: no 128 floor).
  * ``ffn``: ln2 + MLP, ``streamed_ffn`` (gated) / ``streamed_mlp``
    (ungated) / ``moe_experts``; the norm folds into the kernel when fusion
    grouped it with the projections and the norm is RMSNorm.
  * ``mixer``: ``mamba2_scan`` / ``rwkv6_wkv`` for the SSM families.
  * ``lm_head``: final norm + LM head + loss through ``streamed_xent``
    (training).

Under a weight-quantizing config (``w8``, ``w8_kv8``) the ``rmsnorm_matmul``
and ``streamed_ffn`` / ``streamed_mlp`` stages carry the ``("w8", 1)`` flag
that dispatches their int8 twins; KV quantization changes no choice (the
pools' dtype selects the attention twins).

Block sizes are ``max(dse_tile, 128)``, the reference's floor, so that a
plan compares field for field with the reference's; they are hints: each
Hopper kernel picks its own tiles from the shapes (``kernels/common.py``'s
plan functions).  The page size, the prefill chunk (``block_q`` rounded up
to pages) and the mixers' chunks are what the runtime takes from the plan.

Not ported yet: ``mesh=`` (the per-stage sharding claims need
``distributed/sharding.spec_for``) and ``tune=`` / ``tune_table=`` (the
autotuner); both raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from ..configs.base import ModelConfig
from .dse import evaluate_trial
from .graph import DataflowGraph
from .lowering import CompiledDataflow, compile_model, lower_groups
from .partition import partition
from .platforms import H100, Platform
from .trace import trace_lm_head

LANE = 128      # block-size floor of the reference's plans (its lane width)

Blocks = Tuple[Tuple[str, int], ...]
# (grid_dim, mesh_axis_or_group) claims: a single axis name or a tuple of
# names.
Sharding = Tuple[Tuple[str, object], ...]


@dataclass(frozen=True)
class KernelChoice:
    """One stage's implementation, its block-size targets and the mesh axes
    its block grid shards over (empty: one device).

    ``source`` records where the blocks came from: ``"analytic"`` (the
    DSE's modeled objective) or ``"measured"`` (an autotuner's timings).
    """
    implementation: str          # kernel name in repro_torch.kernels, or "eager"
    blocks: Blocks = ()
    sharding: Sharding = ()
    source: str = "analytic"     # "analytic" | "measured"

    @property
    def fused(self) -> bool:
        return self.implementation != "eager"

    @property
    def kw(self) -> Dict[str, object]:
        """Block sizes (plus the sharding claim) as wrapper kwargs."""
        d: Dict[str, object] = dict(self.blocks)
        if self.sharding:
            d["shard"] = self.sharding
        return d

    def block(self, name: str, default: int = 0) -> int:
        """One named block-size target (``default`` when absent): the
        accessor the static checks (``analysis/``) read."""
        return int(dict(self.blocks).get(name, default))

    def claim(self, dim: str):
        """Mesh axis (or axis group) claimed for ``dim``; None when the
        dim is unclaimed (replicated)."""
        return dict(self.sharding).get(dim)


EAGER = KernelChoice("eager")

# Stage slots every LayerPlan carries, in pipeline order: the order the
# itensor pass walks producer/consumer pairs in.
STAGES = ("qkv", "attention", "decode_attn", "verify_attn", "ffn", "mixer")


@dataclass(frozen=True)
class LayerPlan:
    """Kernel choices for one layer kind."""
    kind: str
    qkv: KernelChoice = EAGER          # (ln1 +) Q/K/V projections
    attention: KernelChoice = EAGER    # chunk / whole-prompt attention
    decode_attn: KernelChoice = EAGER  # single-token paged attention
    verify_attn: KernelChoice = EAGER  # W-token speculative verify window
    ffn: KernelChoice = EAGER          # (ln2 +) MLP / MoE
    mixer: KernelChoice = EAGER        # the Mamba2 SSD scan / RWKV6 wkv

    @property
    def any_fused(self) -> bool:
        return any(c.fused for _, c in self.stages())

    def stages(self):
        """Yield ``(stage_name, KernelChoice)`` in pipeline order."""
        for name in STAGES:
            yield name, getattr(self, name)


@dataclass(frozen=True)
class StreamPlan:
    """Per-layer-kind kernel choices for one (config, shape) pair."""
    arch: str
    tokens: int
    kv_len: int
    platform: str
    default_tile_size: int
    overall_unroll_size: int
    layers: Tuple[Tuple[str, LayerPlan], ...]   # kind -> plan
    quant: str = "none"          # the config's quant mode
    lm_head: KernelChoice = EAGER  # final norm + LM head + loss (training)
    modeled_latency_s: float = 0.0
    fusion_groups: int = 0
    implementations: Tuple[str, ...] = ()
    mesh_axes: Tuple[Tuple[str, int], ...] = ()   # mesh the plan targets
    # The static verifier's record (``analysis.verify_plan``): None when
    # never verified; the engine attaches it with ``with_verification``.
    verified: Optional[bool] = None
    diagnostics: Tuple[str, ...] = ()
    # Plan-level cost provenance: "analytic" (the DSE's model), "measured"
    # or "hybrid" (an autotuner's).
    cost_source: str = "analytic"

    def layer(self, kind: str) -> LayerPlan:
        for k, lp in self.layers:
            if k == kind:
                return lp
        return LayerPlan(kind=kind)

    def decode_page_size(self, default: int = 16) -> int:
        """KV page size: the DSE tile the plan's paged-attention choice
        carries, or ``default`` when no layer plans a paged decode stage."""
        for _, lp in self.layers:
            if lp.decode_attn.fused:
                return lp.decode_attn.kw.get("page_size", default)
        return default

    def verify_window(self, draft_len: int) -> int:
        """Speculative verify-window rows (pending token + drafts) for a
        requested draft length, clamped to the decode KV page granule: a
        window never spans more than one page of fresh K/V, so a rejected
        draft rolls back at most one freshly opened page."""
        return max(2, min(int(draft_len) + 1, self.decode_page_size()))

    def prefill_chunk_size(self, page_size: int, default: int = 128) -> int:
        """Chunked-prefill granule: the attention ``block_q`` rounded up to
        whole KV pages, so chunk boundaries land on page boundaries."""
        base = default
        for _, lp in self.layers:
            if lp.attention.fused:
                base = int(lp.attention.kw.get("block_q", default))
                break
        ps = max(1, int(page_size))
        return max(1, -(-int(base) // ps)) * ps

    def stage_choices(self):
        """Yield every stage's ``(owner, stage_name, KernelChoice)``: layer
        stages, then the LM head (``owner`` the layer kind, or "final")."""
        for kind, lp in self.layers:
            for stage, choice in lp.stages():
                yield kind, stage, choice
        yield "final", "lm_head", self.lm_head

    def with_verification(self, verified: bool,
                          diagnostics: Tuple[str, ...]) -> "StreamPlan":
        """Copy of the plan carrying a verification verdict."""
        return replace(self, verified=bool(verified),
                       diagnostics=tuple(diagnostics))

    def with_stage(self, owner: str, stage: str,
                   choice: KernelChoice) -> "StreamPlan":
        """Copy of the plan with one stage's choice replaced (``owner`` the
        layer kind, or "final" for the LM head), addressing the pairs
        ``stage_choices`` yields."""
        if owner == "final" and stage == "lm_head":
            return replace(self, lm_head=choice)
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r} (have {STAGES})")
        if not any(k == owner for k, _ in self.layers):
            raise ValueError(f"plan has no layer kind {owner!r}")
        layers = tuple(
            (k, replace(lp, **{stage: choice}) if k == owner else lp)
            for k, lp in self.layers)
        return replace(self, layers=layers)

    def summary(self) -> Dict[str, object]:
        return {
            "arch": self.arch,
            "quant": self.quant,
            "tokens": self.tokens,
            "kv_len": self.kv_len,
            "tile": self.default_tile_size,
            "unroll": self.overall_unroll_size,
            "fusion_groups": self.fusion_groups,
            "modeled_latency_s": self.modeled_latency_s,
            "mesh": dict(self.mesh_axes),
            "stages": {
                kind: {stage: choice.implementation
                       for stage, choice in lp.stages()}
                for kind, lp in self.layers
            },
            "sharding": {
                kind: {stage: dict(choice.sharding)
                       for stage, choice in lp.stages() if choice.sharding}
                for kind, lp in self.layers
            },
            "lm_head": self.lm_head.implementation,
            "lm_head_sharding": dict(self.lm_head.sharding),
            "verified": self.verified,
            "diagnostics": list(self.diagnostics),
            "plan_source": self.cost_source,
            "stage_sources": {
                f"{kind}.{stage}": choice.source
                for kind, stage, choice in self.stage_choices()
                if choice.fused and choice.source != "analytic"
            },
        }


# --------------------------------------------------------------------- #
# Builder
# --------------------------------------------------------------------- #

def _tile(graph: DataflowGraph, kernel: str, dim: str,
          default: int = LANE) -> int:
    """The DSE tile of ``kernel``'s ``dim``, floored at ``LANE``."""
    try:
        dec = graph.kernel(kernel).tags["decision"]
    except KeyError:
        return default
    return max(int(dec.tile_sizes.get(dim, default)), LANE)


def _raw_tile(graph: DataflowGraph, kernel: str, dim: str,
              default: int = 16) -> int:
    """The DSE tile without the floor: for streaming granules (the KV page
    size) rather than block operands."""
    try:
        dec = graph.kernel(kernel).tags["decision"]
    except KeyError:
        return default
    return int(dec.tile_sizes.get(dim, default))


def _group_impl(compiled: CompiledDataflow, kernel: str) -> str:
    """Implementation of the fusion group holding ``kernel``;
    "xla_fusion" when unfused or absent from the graph."""
    for g in compiled.lowered:
        if kernel in g.kernels:
            return g.implementation
    return "xla_fusion"


def _same_group(compiled: CompiledDataflow, a: str, b: str) -> bool:
    for g in compiled.lowered:
        if a in g.kernels:
            return b in g.kernels
    return False


def _layer_plan(cfg: ModelConfig, compiled: CompiledDataflow, kind: str,
                base: str) -> LayerPlan:
    """Map one compiled block graph onto stage-level kernel choices.

    A stage goes fused only when the fusion pass put its anchor kernel in a
    group that lowered to a kernel pattern (not ``xla_fusion``): the
    compiler, not the runtime, decides what streams.
    """
    g = compiled.trial.graph
    assert g is not None

    def fused_at(anchor: str) -> bool:
        return _group_impl(compiled, anchor) != "xla_fusion"

    qkv = attention = decode_attn = verify_attn = ffn = mixer = EAGER

    if kind in ("attn", "local_attn", "global_attn", "mamba+shared_attn"):
        ab = f"{base}.shared" if kind == "mamba+shared_attn" else base
        if fused_at(f"{ab}.q_proj"):
            # The shared block's pre-attention norm is traced as
            # "<base>.shared.ln"; attention blocks use "<base>.ln1".
            ln = f"{ab}.ln" if kind == "mamba+shared_attn" else f"{ab}.ln1"
            norm_fused = (cfg.norm == "rmsnorm"
                          and _same_group(compiled, ln, f"{ab}.q_proj"))
            impl = "rmsnorm_matmul" if norm_fused else "block_matmul"
            blocks: Blocks = (
                ("block_t", _tile(g, f"{ab}.q_proj", "t")),
                ("block_n", _tile(g, f"{ab}.q_proj", "dq")),
            )
            # Weight-only int8: only rmsnorm_matmul has a w8 twin;
            # block_matmul (the LayerNorm configs) stays full precision.
            if cfg.weight_quant and impl == "rmsnorm_matmul":
                blocks += (("w8", 1),)
            qkv = KernelChoice(impl, blocks)
        if fused_at(f"{ab}.attention"):
            attention = KernelChoice("flash_attention", (
                ("block_q", _tile(g, f"{ab}.attention", "t")),
                ("block_kv", _tile(g, f"{ab}.attention", "s")),
            ))
            # The decode and verify twins of the same fusion decision
            # stream the paged KV cache; the KV-dim tile is the page size.
            decode_attn = KernelChoice("paged_attention", (
                ("page_size", _raw_tile(g, f"{ab}.attention", "s")),
            ))
            verify_attn = KernelChoice("verify_attention", (
                ("page_size", _raw_tile(g, f"{ab}.attention", "s")),
            ))
        mb = f"{ab}.moe" if cfg.is_moe else f"{ab}.mlp"
        if cfg.is_moe and cfg.gated_ffn and fused_at(f"{mb}.experts"):
            ffn = KernelChoice("moe_experts", (
                ("block_t", _tile(g, f"{mb}.experts", "t")),
            ))
        elif not cfg.is_moe and fused_at(f"{mb}.up_proj"):
            norm_fused = (cfg.norm == "rmsnorm" and _same_group(
                compiled, f"{ab}.ln2", f"{mb}.up_proj"))
            impl = "streamed_ffn" if cfg.gated_ffn else "streamed_mlp"
            fblocks: Blocks = (
                ("block_t", _tile(g, f"{mb}.up_proj", "t")),
                ("block_f", _tile(g, f"{mb}.up_proj", "f")),
                ("fuse_norm", int(norm_fused)),
            )
            if cfg.weight_quant:
                fblocks += (("w8", 1),)
            ffn = KernelChoice(impl, fblocks)

    if kind in ("mamba", "mamba+shared_attn"):
        if fused_at(f"{base}.ssm_scan"):
            mixer = KernelChoice("mamba2_scan", (
                ("chunk", _tile(g, f"{base}.ssm_scan", "t")),
            ))

    if kind == "rwkv":
        if fused_at(f"{base}.wkv"):
            mixer = KernelChoice("rwkv6_wkv", (
                ("chunk", min(64, _tile(g, f"{base}.wkv", "t"))),
            ))

    return LayerPlan(kind=kind, qkv=qkv, attention=attention,
                     decode_attn=decode_attn, verify_attn=verify_attn,
                     ffn=ffn, mixer=mixer)


def build_stream_plan(cfg: ModelConfig, *, tokens: int,
                      kv_len: Optional[int] = None,
                      platform: Platform = H100,
                      dse_budget: int = 8,
                      mesh=None, tune=None, tune_table=None,
                      cost_source=None) -> StreamPlan:
    """Run the StreamTensor pipeline over every distinct layer kind of
    ``cfg`` for ``platform`` and collapse the result into a plan.

    The DSE explores the tiling space once, on the first layer kind (the
    paper's hyperparameters are global); the other kinds and the LM head
    are compiled as single trials with the winning parameters.
    ``cost_source=`` (a ``dse.CostSource``) goes to the DSE objective.
    """
    if mesh is not None:
        raise NotImplementedError(
            "build_stream_plan(mesh=...): the per-stage sharding claims "
            "need distributed/sharding.spec_for, not ported yet (ROADMAP "
            "queue 1 item 10)")
    if (tune is not None and tune is not False) or tune_table is not None:
        raise NotImplementedError(
            "build_stream_plan(tune=/tune_table=): the autotuner is not "
            "ported yet (ROADMAP queue 1 item 7)")
    kinds: Dict[str, int] = {}
    for i in range(cfg.num_layers):
        kinds.setdefault(cfg.layer_kind(i), i)

    layers = []
    first = True
    tile, unroll = None, None
    latency = 0.0
    groups = 0
    impls: Tuple[str, ...] = ()
    for kind, idx in kinds.items():
        compiled = compile_model(
            cfg, tokens=tokens, kv_len=kv_len, platform=platform,
            layer_index=idx,
            dse_budget=dse_budget if first else 1,
            default_tile_size=None if first else tile,
            overall_unroll_size=None if first else unroll,
            cost_source=cost_source)
        if first:
            tile = compiled.trial.params["default_tile_size"]
            unroll = compiled.trial.params["overall_unroll_size"]
            first = False
        latency += compiled.trial.latency_s
        groups += compiled.fusion.num_groups
        impls += tuple(lg.implementation for lg in compiled.lowered)
        layers.append((kind, _layer_plan(cfg, compiled, kind,
                                         base=f"L{idx}")))

    # LM head: norm + head matmul + loss.  The loss consumer is not part of
    # the block trace, so the streamed-xent choice is made here; its blocks
    # come from the head matmul's tiling decision.
    head_trial = evaluate_trial(trace_lm_head(cfg, tokens), platform,
                                tile or LANE, unroll or 64,
                                keep_artifacts=True,
                                cost_source=cost_source)
    assert head_trial.graph is not None and head_trial.fusion is not None
    head_lowered = lower_groups(head_trial.graph, head_trial.fusion,
                                partition(head_trial.graph, 1))
    head_fused = any(lg.implementation != "xla_fusion"
                     for lg in head_lowered
                     if "final.lm_head" in lg.kernels)
    lm_head = EAGER
    if head_fused:
        lm_head = KernelChoice("streamed_xent", (
            ("block_t", _tile(head_trial.graph, "final.lm_head", "t")),
            ("block_v", max(_tile(head_trial.graph, "final.lm_head", "v"),
                            512)),
        ))
    latency += head_trial.latency_s
    groups += head_trial.fusion.num_groups
    impls += tuple(lg.implementation for lg in head_lowered)

    return StreamPlan(
        arch=cfg.name, tokens=tokens, kv_len=kv_len or tokens,
        platform=platform.name,
        default_tile_size=tile or LANE, overall_unroll_size=unroll or 64,
        layers=tuple(layers), quant=cfg.quant, lm_head=lm_head,
        modeled_latency_s=latency, fusion_groups=groups,
        implementations=impls)


@functools.lru_cache(maxsize=64)
def _plan_for_base(cfg: ModelConfig, tokens: int,
                   kv_len: Optional[int] = None) -> StreamPlan:
    return build_stream_plan(cfg, tokens=tokens, kv_len=kv_len,
                             platform=H100)


def plan_for(cfg: ModelConfig, tokens: int,
             kv_len: Optional[int] = None) -> Optional[StreamPlan]:
    """The plan the model entry points run: ``build_stream_plan`` for the
    H100 at ``tokens`` tokens over ``kv_len`` cached positions, cached on
    the (frozen) config and the shape; None when ``cfg.use_fused_kernels``
    is off (the eager plan).  A new shape costs one DSE on the host
    (tens of milliseconds) until the cache holds it."""
    if not cfg.use_fused_kernels:
        return None
    return _plan_for_base(cfg, int(tokens),
                          None if kv_len is None else int(kv_len))


# Cache management passthrough (tests clear plan caches between configs).
plan_for.cache_clear = _plan_for_base.cache_clear    # type: ignore[attr-defined]
plan_for.cache_info = _plan_for_base.cache_info      # type: ignore[attr-defined]
