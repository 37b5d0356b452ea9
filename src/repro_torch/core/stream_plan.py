"""StreamPlan records: which kernel serves each stage, with block hints.

Copies ``KernelChoice`` / ``LayerPlan`` / ``StreamPlan`` from
``repro.core.stream_plan`` (the fields the port reads) and adds
``plan_for``, which returns the plan the reference compiler (trace ->
tiling DSE -> fusion -> lowering) selects for the two ported families:
dense RMSNorm/GQA/SwiGLU/RoPE (llama3-8b) and dense LayerNorm/MHA/GELU-MLP
with learned positions (gpt2).  The reference selects the same kernels and
blocks for each family's config and its reduced config at every token
count, and at every KV length that is a multiple of the 16-token page
(the engine asks for ``max_len``); a test pins this table to the reference
``plan_for``.
The compiler itself (``repro.core`` and a Hopper ``Platform``) is ported
in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
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


def _family_plan(cfg: ModelConfig) -> Optional[LayerPlan]:
    """The ported family ``cfg`` belongs to, or None."""
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if (kinds != {"attn"} or cfg.is_moe or cfg.qkv_bias or cfg.qk_norm
            or cfg.quant != "none"):
        return None
    if cfg.norm == "rmsnorm" and cfg.gated_ffn and cfg.rope == "rope":
        return _DENSE_RMSNORM_GLU
    if cfg.norm == "layernorm" and not cfg.gated_ffn and cfg.rope == "none":
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
            "RMSNorm/GQA/SwiGLU/RoPE and LayerNorm/MHA/GELU-MLP/learned-"
            "position stacks without quantization are ported")
    return StreamPlan(arch=cfg.name, tokens=int(tokens),
                      kv_len=int(kv_len or tokens), layers=(("attn", lp),))
