"""Pass 2: kernel lint for the Hopper kernels (block legality, shared
memory, the cases the CUDA builds run, scale operands).

Checks every fused ``KernelChoice`` against the model dimensions without
launching a kernel:

  * implementation names must be known kernels (a plan naming a kernel
    the runtime doesn't have dispatches nothing);
  * feature-dim block targets honor the 128 floor and either divide their
    extent or clip (``kernels/common.pick_block``) to an aligned divisor,
    as the reference's lint holds them, with one difference: a target
    that is a whole number of 128-wide tiles passes whatever its extent.
    The Hopper kernels take the targets as hints and tile every dim
    themselves (the vocabulary padded to 256), and the DSE's LM-head
    ``block_v`` of 512 divides none of the registry's full vocabularies:
    the reference's rule refuses its own full-width gpt2 and granite
    plans (ROADMAP queue 3);
  * the shared memory a block of each Hopper kernel the stage launches
    requests at the plan's shapes (``smem_estimate``; each wrapper
    module's ``smem_bytes``, the tiles from the plan functions the
    wrappers use) must fit one block's opt-in limit, 227 KB on the H100
    (``smem-exceeded``).  The kernels fill shared memory by design, so
    there is no warning below the limit;
  * on ``device="cuda"``, a case a CUDA build refuses is an error
    (``unsupported-case``), from the predicate the wrapper raises with
    (each wrapper module's ``cuda_refusal``); the plain versions run
    every case on the CPU;
  * the paged / verify / offset entry points' scale operands must agree
    with the plan's quant mode (code pools ride two float32 scale
    operands beside the pages: the reference's scalar-prefetch arity),
    and the plan's quant mode must agree with the config's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..configs.base import ModelConfig
from ..core.platforms import Platform
from ..core.stream_plan import LANE, KernelChoice, StreamPlan
# Each wrapper module's shared-memory count and refusal predicate, the
# functions its wrapper launches and raises by (the package exports the
# wrappers under the modules' names, so these are imported by name).
from ..kernels.block_matmul import smem_bytes as block_matmul_smem
from ..kernels.flash_attention import cuda_refusal as flash_refusal
from ..kernels.flash_attention import smem_bytes as flash_smem
from ..kernels.mamba2_scan import case_refusal as ssd_refusal
from ..kernels.mamba2_scan import smem_bytes as ssd_smem
from ..kernels.moe_experts import cuda_refusal as moe_refusal
from ..kernels.moe_experts import smem_bytes as moe_smem
from ..kernels.paged_attention import cuda_refusal as paged_refusal
from ..kernels.paged_attention import smem_bytes as paged_smem
from ..kernels.rmsnorm_matmul import smem_bytes as rmsnorm_matmul_smem
from ..kernels.rwkv6_wkv import cuda_refusal as wkv_refusal
from ..kernels.rwkv6_wkv import smem_bytes as wkv_smem
from ..kernels.streamed_ffn import cuda_refusal as ffn_refusal
from ..kernels.streamed_ffn import smem_bytes as ffn_smem
from ..kernels.streamed_xent import smem_bytes as xent_smem
from ..kernels.common import MAX_SMEM, pick_block
from .diagnostics import Diagnostic

# Every implementation name a KernelChoice may carry -> the block names
# it understands.  (Extra block entries like "fuse_norm"/"w8" are flags.)
KNOWN_KERNELS: Dict[str, Tuple[str, ...]] = {
    "eager": (),
    "rmsnorm_matmul": ("block_t", "block_n", "w8"),
    "block_matmul": ("block_t", "block_n"),
    "flash_attention": ("block_q", "block_kv"),
    "paged_attention": ("page_size",),
    "verify_attention": ("page_size",),
    "streamed_ffn": ("block_t", "block_f", "fuse_norm", "w8"),
    "streamed_mlp": ("block_t", "block_f", "fuse_norm", "w8"),
    "moe_experts": ("block_t",),
    "mamba2_scan": ("chunk",),
    "rwkv6_wkv": ("chunk",),
    "streamed_xent": ("block_t", "block_v"),
}

# Pointer operands of the C entry points, (full-precision, code) K/V: the
# code twins take the k and v scales beside the pages
# (``paged_attention.py::_entry``, ``flash_attention.py::_entry``).
SCALE_OPERANDS: Dict[str, Tuple[int, int]] = {
    "paged_attention": (7, 9),
    "verify_attention": (7, 9),
    "flash_attention": (4, 6),
}

_KV_QUANT_MODES = ("kv_int8", "kv_fp8", "w8_kv8")


def _feature_blocks(cfg: ModelConfig, stage: str, choice: KernelChoice,
                    kv_len: int) -> List[Tuple[str, int]]:
    """(block_name, extent) for the floor-sensitive dims of a stage."""
    impl = choice.implementation
    if stage == "qkv":
        return [("block_n", min(cfg.q_dim, cfg.kv_dim))]
    if stage == "attention":
        return [("block_kv", kv_len)]
    if stage == "ffn" and impl in ("streamed_ffn", "streamed_mlp"):
        return [("block_f", cfg.d_ff)]
    if stage == "lm_head":
        return [("block_v", cfg.vocab_size)]
    return []


def _dtype(cfg: ModelConfig):
    from ..models.params import compute_dtype
    return compute_dtype(cfg)


def _code(cfg: ModelConfig):
    from ..serving.kv_cache import kv_quant_dtype
    return kv_quant_dtype(cfg.kv_quant)


def _group(cfg: ModelConfig) -> int:
    return max(1, cfg.num_heads // max(1, cfg.num_kv_heads))


def _verify_rows(cfg: ModelConfig, plan: StreamPlan) -> int:
    """Rows a verify block holds at the plan's widest window."""
    return plan.verify_window(plan.decode_page_size()) * _group(cfg)


def _launches(cfg: ModelConfig, impl: str) -> bool:
    """Whether a path of the config launches the stage's kernel: decode
    only where the config serves, verify only where it decodes
    speculatively (``models.model.supports_speculative``)."""
    from ..models.model import supports_speculative
    if impl == "paged_attention":
        return not cfg.encoder_only
    if impl == "verify_attention":
        return supports_speculative(cfg)
    return True


def stage_kernels(cfg: ModelConfig, plan: StreamPlan, stage: str,
                  choice: KernelChoice) -> Optional[Dict[str, int]]:
    """{kernel: static + dynamic shared memory per block, bytes} of every
    Hopper kernel the stage launches at the plan's shapes (``tokens``
    rows, the config's widths and dtype, the quant mode's code pools);
    None for eager stages and unknown kernels.  Kernels are named as a
    profiler reports them (``kernels.common.kernel_key``)."""
    if not choice.fused:
        return None
    impl = choice.implementation
    if not _launches(cfg, impl):
        return {}
    dt = _dtype(cfg)
    t = max(1, plan.tokens)
    hd = cfg.head_dim_
    if impl == "rmsnorm_matmul":
        return rmsnorm_matmul_smem(t, dt, w8=bool(choice.block("w8")))
    if impl == "block_matmul":
        return block_matmul_smem(t, dt)
    if impl == "flash_attention":
        # The static branch (K7) and the offset one (K2) share instances;
        # the twin over codes (K9c) runs where prompts prefill in chunks.
        from ..models.model import supports_chunked_prefill
        out = dict(flash_smem(hd, dt))
        if _code(cfg) is not None and supports_chunked_prefill(cfg):
            out.update(flash_smem(hd, dt, _code(cfg)))
        return out
    if impl in ("paged_attention", "verify_attention"):
        rows = (_group(cfg) if impl == "paged_attention"
                else _verify_rows(cfg, plan))
        return paged_smem(hd, rows, dt, _code(cfg))
    if impl in ("streamed_ffn", "streamed_mlp"):
        return ffn_smem(
            t, cfg.d_model, cfg.d_ff, dt, gated=impl == "streamed_ffn",
            norm=bool(choice.block("fuse_norm")),
            silu=cfg.activation == "silu", w8=bool(choice.block("w8")))
    if impl == "moe_experts":
        return moe_smem(t, cfg.d_model, cfg.d_ff, dt)
    if impl == "mamba2_scan":
        from ..models.model import _chunk_of
        q = _chunk_of(t, choice.block("chunk", 128) or 128)
        return ssd_smem(q, cfg.ssm_head_dim, cfg.ssm_state, dt)
    if impl == "rwkv6_wkv":
        return wkv_smem(cfg.rwkv_head_dim, dt)
    if impl == "streamed_xent":
        return xent_smem(dt)
    return None     # unknown kernel: reported separately


def smem_estimate(cfg: ModelConfig, plan: StreamPlan, stage: str,
                  choice: KernelChoice) -> Optional[int]:
    """The most static + dynamic shared memory, in bytes, a block of the
    Hopper kernels the stage launches requests at the plan's shapes;
    None for eager stages."""
    kernels = stage_kernels(cfg, plan, stage, choice)
    return max(kernels.values()) if kernels else None


def _refusals(cfg: ModelConfig, plan: StreamPlan, kind: str, stage: str,
              choice: KernelChoice) -> List[str]:
    """Why a CUDA build would refuse a case this stage runs, from the
    wrappers' own predicates; empty when the card runs it all."""
    from ..models.model import supports_chunked_prefill
    impl = choice.implementation
    if not _launches(cfg, impl):
        return []
    hd = cfg.head_dim_
    why: List[Optional[str]] = []
    if impl == "flash_attention":
        window = cfg.sliding_window if kind == "local_attn" else 0
        branches = ["static"]
        if supports_chunked_prefill(cfg):
            branches.append("offset")
            if cfg.kv_quant is not None:
                branches.append("offset_q")
        why += [flash_refusal(b, hd, cfg.causal, window) for b in branches]
    elif impl == "paged_attention":
        why.append(paged_refusal(hd, _group(cfg), verify=False))
    elif impl == "verify_attention":
        why.append(paged_refusal(hd, _verify_rows(cfg, plan), verify=True))
    elif impl in ("streamed_ffn", "streamed_mlp"):
        why.append(ffn_refusal(impl == "streamed_ffn", cfg.activation,
                               bool(choice.block("fuse_norm"))))
    elif impl == "moe_experts":
        why.append(moe_refusal(cfg.activation))
    elif impl == "mamba2_scan":
        # (A chunk past the shared memory is ``smem-exceeded``.)
        why.append(ssd_refusal(cfg.ssm_head_dim, cfg.ssm_state,
                               _dtype(cfg)))
    elif impl == "rwkv6_wkv":
        why.append(wkv_refusal(cfg.rwkv_head_dim))
    return [w for w in why if w is not None]


def check_kernels(plan: StreamPlan, cfg: ModelConfig, platform: Platform,
                  device: str = "cuda") -> List[Diagnostic]:
    diags: List[Diagnostic] = []

    if plan.quant != cfg.quant:
        diags.append(Diagnostic(
            "error", "kernel", "plan", "quant-mismatch",
            f"plan was built under quant mode {plan.quant!r} but is "
            f"verified against a config in mode {cfg.quant!r} — kernel "
            "twins and pool dtypes would disagree",
            "rebuild the plan with the config's quant mode "
            "(plans are cached per config)"))

    kv_quant = cfg.kv_quant is not None
    for kind, stage, choice in plan.stage_choices():
        if not choice.fused:
            continue
        where = f"{kind}.{stage}"
        impl = choice.implementation

        if impl not in KNOWN_KERNELS:
            diags.append(Diagnostic(
                "error", "kernel", where, "unknown-kernel",
                f"implementation {impl!r} is not a known kernel",
                f"one of {sorted(k for k in KNOWN_KERNELS if k != 'eager')}"))
            continue

        # w8 flags must agree with the config's weight-quant mode.
        if choice.block("w8") and not cfg.weight_quant:
            diags.append(Diagnostic(
                "error", "kernel", where, "w8-without-weight-quant",
                f"{impl} carries the w8 flag but cfg.quant={cfg.quant!r} "
                "has no weight quantization — the wrapper would "
                "quantize weights the checkpoint math doesn't expect",
                "drop the w8 block flag or set quant=w8/w8_kv8"))

        # Feature-dim block targets: the floor + divisibility.
        for bname, extent in _feature_blocks(cfg, stage, choice,
                                             plan.kv_len):
            target = choice.block(bname)
            if target <= 0 or extent <= 0:
                continue
            if target % LANE == 0:
                continue        # whole 128-wide tiles: see the docstring
            if extent >= LANE and target < LANE:
                diags.append(Diagnostic(
                    "error", "kernel", where, "lane-floor",
                    f"{bname}={target} is below the {LANE}-lane floor "
                    f"for a {extent}-wide dim — the MXU tile would be "
                    "lane-misaligned",
                    f"raise {bname} to a multiple of {LANE}"))
                continue
            if target <= extent and extent % target != 0:
                eff = pick_block(extent, target)
                diags.append(Diagnostic(
                    "warning", "kernel", where, "non-divisible-block",
                    f"{bname}={target} does not divide the {extent}-wide "
                    f"dim; the wrapper will clip it to {eff}",
                    f"use a {bname} that divides {extent} so the plan's "
                    "tile is the tile that runs"))
                if extent >= LANE and eff % LANE != 0:
                    diags.append(Diagnostic(
                        "error", "kernel", where, "unaligned-block",
                        f"no lane-aligned divisor of {extent} exists at "
                        f"or below {bname}={target}; the clip lands on "
                        f"{eff}, an MXU-illegal tile",
                        f"pad the dim to a multiple of {LANE} or pick a "
                        "dividing block"))

        # Paged stream granule sanity.
        if impl in ("paged_attention", "verify_attention"):
            ps = choice.block("page_size", 0)
            if ps <= 0:
                diags.append(Diagnostic(
                    "error", "kernel", where, "bad-page-size",
                    f"{impl} carries page_size={ps}",
                    "page_size must be a positive KV stream granule"))

        # The Hopper kernels' shared memory against one block's limit.
        kernels = stage_kernels(cfg, plan, stage, choice) or {}
        for kname, nbytes in kernels.items():
            if nbytes > MAX_SMEM:
                diags.append(Diagnostic(
                    "error", "kernel", where, "smem-exceeded",
                    f"{kname} needs {nbytes} B of shared memory per "
                    f"block at the plan's shapes; an H100 block may "
                    f"take {MAX_SMEM} B",
                    "shrink the stage's tile (its chunk) or its shapes"))

        # Cases the CUDA builds refuse, where the plan runs on the card.
        if device == "cuda":
            for why in _refusals(cfg, plan, kind, stage, choice):
                diags.append(Diagnostic(
                    "error", "kernel", where, "unsupported-case",
                    f"{impl}: {why}",
                    "serve this config on the CPU (device='cpu'), or add "
                    "the case to the CUDA build"))

        # Scale operands of the paged / verify / offset entry points.
        if impl in SCALE_OPERANDS:
            base, quant_arity = SCALE_OPERANDS[impl]
            expect = quant_arity if kv_quant else base
            have = (quant_arity if plan.quant in _KV_QUANT_MODES
                    else base)
            if have != expect:
                diags.append(Diagnostic(
                    "error", "kernel", where, "prefetch-arity",
                    f"{impl} would take {have} pointer operands under "
                    f"plan quant {plan.quant!r} but the config's pools "
                    f"need {expect} (pages ± per-page scales)",
                    "rebuild the plan under the config's quant mode"))
    return diags
