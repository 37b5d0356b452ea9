"""StreamPlan records: which kernel serves each stage, with block hints.

Copies ``KernelChoice`` / ``LayerPlan`` / ``StreamPlan`` from
``repro.core.stream_plan`` (the fields the port reads) and adds
``plan_for``, which returns the plan the reference compiler (trace ->
tiling DSE -> fusion -> lowering) selects for the three ported families:
dense RMSNorm/GQA/SwiGLU/RoPE (llama3-8b), its MoE variant (granite-moe)
and dense LayerNorm/MHA/GELU-MLP with learned positions (gpt2).  The
reference selects the same kernels and blocks for each family's config
and its reduced config at every token count, and at every KV length that
is a multiple of the 16-token page
(the engine asks for ``max_len``); a test pins this table to the reference
``plan_for``.
Under a weight-quantizing config (``w8``, ``w8_kv8``) the
``rmsnorm_matmul`` and ``streamed_ffn`` / ``streamed_mlp`` stages carry the
reference's ``("w8", 1)`` block flag (``stream_plan.py:363-368``,
``:401-402``), which dispatches their int8 kernel twins; ``block_matmul``
and ``moe_experts`` never do, so gpt2's projections and the MoE experts
stay at full precision.  KV quantization changes no choice: the pools'
dtype selects the attention twins.
The plan's ``lm_head`` stage (final norm + LM head + loss, training only)
is ``streamed_xent`` for every family, with the reference's blocks at
every token count.
The compiler itself (``repro.core`` and a Hopper ``Platform``) is ported
in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from ..configs.base import ModelConfig

Blocks = Tuple[Tuple[str, int], ...]


@dataclass(frozen=True)
class KernelChoice:
    """One stage's implementation plus its block-size hints."""
    implementation: str          # kernel name in repro_torch.kernels, or "eager"
    blocks: Blocks = ()

    @property
    def fused(self) -> bool:
        return self.implementation != "eager"

    @property
    def kw(self) -> Dict[str, int]:
        """Block hints as wrapper keyword arguments."""
        return dict(self.blocks)


EAGER = KernelChoice("eager")

# The main-path stages the port runs, in pipeline order.
STAGES = ("qkv", "attention", "decode_attn", "verify_attn", "ffn")


@dataclass(frozen=True)
class LayerPlan:
    """Kernel choices for one layer kind."""
    kind: str
    qkv: KernelChoice = EAGER          # (ln1 +) Q/K/V projections
    attention: KernelChoice = EAGER    # chunk / whole-prompt attention
    decode_attn: KernelChoice = EAGER  # single-token paged attention
    verify_attn: KernelChoice = EAGER  # W-token speculative verify window
    ffn: KernelChoice = EAGER          # (ln2 +) MLP

    def stages(self):
        for name in STAGES:
            yield name, getattr(self, name)


@dataclass(frozen=True)
class StreamPlan:
    """Per-layer-kind kernel choices for one (config, shape) pair."""
    arch: str
    tokens: int
    kv_len: int
    layers: Tuple[Tuple[str, LayerPlan], ...]
    quant: str = "none"          # the config's quant mode
    lm_head: KernelChoice = EAGER  # final norm + LM head + loss (training)

    def layer(self, kind: str) -> LayerPlan:
        for k, lp in self.layers:
            if k == kind:
                return lp
        return LayerPlan(kind=kind)

    def decode_page_size(self, default: int = 16) -> int:
        """KV page size: the page size the plan's paged-attention choice
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


# The reference compiler's selection for the dense RMSNorm / GQA / SwiGLU
# family (repro.core.stream_plan.plan_for on llama3-8b and llama3-8b
# reduced, tokens in {4, 64, 128, 512}, kv_len in {256, 2048, 4096}).
_DENSE_RMSNORM_GLU = LayerPlan(
    kind="attn",
    qkv=KernelChoice("rmsnorm_matmul", (("block_t", 128), ("block_n", 128))),
    attention=KernelChoice("flash_attention",
                           (("block_q", 128), ("block_kv", 128))),
    decode_attn=KernelChoice("paged_attention", (("page_size", 16),)),
    verify_attn=KernelChoice("verify_attention", (("page_size", 16),)),
    ffn=KernelChoice("streamed_ffn",
                     (("block_t", 128), ("block_f", 128), ("fuse_norm", 1))),
)

# ... and for the dense LayerNorm / MHA / GELU-MLP / learned-position
# family (gpt2 and gpt2 reduced, same token counts; kv_len in {256, 1024,
# 2048}): the norms stay eager, so the projections and the MLP run the
# plain tiled kernels.
_DENSE_LAYERNORM_MLP = LayerPlan(
    kind="attn",
    qkv=KernelChoice("block_matmul", (("block_t", 128), ("block_n", 128))),
    attention=KernelChoice("flash_attention",
                           (("block_q", 128), ("block_kv", 128))),
    decode_attn=KernelChoice("paged_attention", (("page_size", 16),)),
    verify_attn=KernelChoice("verify_attention", (("page_size", 16),)),
    ffn=KernelChoice("streamed_mlp",
                     (("block_t", 128), ("block_f", 128), ("fuse_norm", 0))),
)


# ... and for the MoE RMSNorm / GQA / SwiGLU-experts / RoPE family
# (granite-moe-1b-a400m, granite-moe-3b-a800m and their reduced configs,
# tokens in {4, 20, 128, 2048}, kv_len 2048): llama3's attention stages,
# the experts through ``moe_experts`` with ln2 eager in front (the
# reference applies it, then calls ``fused_moe_ffn``).
_MOE_RMSNORM_GLU = LayerPlan(
    kind="attn",
    qkv=_DENSE_RMSNORM_GLU.qkv,
    attention=_DENSE_RMSNORM_GLU.attention,
    decode_attn=_DENSE_RMSNORM_GLU.decode_attn,
    verify_attn=_DENSE_RMSNORM_GLU.verify_attn,
    ffn=KernelChoice("moe_experts", (("block_t", 128),)),
)


# The training loss of every family (the reference's ``lm_head`` choice
# at token counts 64..8192, full and reduced configs).
_STREAMED_XENT = KernelChoice("streamed_xent",
                              (("block_t", 128), ("block_v", 512)))


def _family_plan(cfg: ModelConfig) -> Optional[LayerPlan]:
    """The ported family ``cfg`` belongs to, or None."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if kinds != {"attn"} or cfg.qkv_bias or cfg.qk_norm:
        return None
    if cfg.norm == "rmsnorm" and cfg.gated_ffn and cfg.rope == "rope":
        return _MOE_RMSNORM_GLU if cfg.is_moe else _DENSE_RMSNORM_GLU
    if (cfg.norm == "layernorm" and not cfg.gated_ffn and cfg.rope == "none"
            and not cfg.is_moe):
        return _DENSE_LAYERNORM_MLP
    return None


def plan_for(cfg: ModelConfig, tokens: int,
             kv_len: Optional[int] = None) -> Optional[StreamPlan]:
    """The plan for ``cfg`` at ``tokens`` tokens over ``kv_len`` cached
    positions, or None when ``cfg.use_fused_kernels`` is off (eager)."""
    if not cfg.use_fused_kernels:
        return None
    lp = _family_plan(cfg)
    if lp is None:
        raise NotImplementedError(
            f"the port has no plan for {cfg.name!r} yet: only dense "
            "RMSNorm/GQA/SwiGLU/RoPE (and its MoE variant) and LayerNorm/"
            "MHA/GELU-MLP/learned-position stacks are ported")
    if cfg.weight_quant:
        w8 = (("w8", 1),)
        if lp.ffn.implementation != "moe_experts":      # K12 has no w8 twin
            lp = replace(lp, ffn=replace(lp.ffn, blocks=lp.ffn.blocks + w8))
        if lp.qkv.implementation == "rmsnorm_matmul":
            lp = replace(lp, qkv=replace(lp.qkv, blocks=lp.qkv.blocks + w8))
    return StreamPlan(arch=cfg.name, tokens=int(tokens),
                      kv_len=int(kv_len or tokens), layers=(("attn", lp),),
                      quant=cfg.quant, lm_head=_STREAMED_XENT)
