"""Autotuner: lint-pruned candidate search over per-family block lattices.

A copy of the reference's ``repro.tuning.autotune`` for the port's plans
and Hopper kernels.  For every fused stage of a ``StreamPlan`` the tuner

  1. enumerates the kernel family's ``TUNE_SPACE`` lattice (declared next
     to each wrapper in ``repro_torch.kernels.*``, the reference's
     lattices), always keeping the plan's original choice as a candidate
     and collapsing points that run the same program (``_signature``);
  2. prunes the lattice BEFORE anything is launched or timed by running
     the kernel lint (``analysis.kernel_lint.check_kernels``, for the
     tuner's device) on a stage-swapped copy of the plan: a candidate
     that draws any error OR warning at its own stage (block rule, shared
     memory, a case the CUDA build refuses) is discarded, so the tuned
     table can never select a plan the static verifier rejects;
  3. scores the survivors through the persistent ``TuneTable``: a hit
     reuses the stored latency, a miss measures the candidate (CUDA
     events on the card, the analytic surrogate on the CPU) and fills the
     table; the winning ``KernelChoice`` carries its cost provenance.

Where it differs from the reference:

  * ``Tuner(device=)`` (None: the card, which raises where there is none)
    goes to measurement, to the table's backend fingerprint and to the
    lint's ``device``;
  * a page-size candidate must leave the verify stage, which inherits it,
    clean too: the verify kernel's rows grow with the page (the plan's
    widest window), and the card caps them;
  * on the card the signature keeps only the block names that change what
    the card runs (each kernel module's ``CARD_BLOCKS``: the page size,
    the attention ``block_q`` through the prefill chunk, the float32 SSD
    chunk), so candidates that differ only in hints the Hopper kernels
    ignore collapse onto the original and each such stage is timed once.
    On the CPU it is the reference's clip identity, so that CPU-tuned
    plans equal the reference's;
  * on the card the original choice, which is never pruned, is scored by
    the surrogate without a launch when the lint refuses it there;
  * ``_platform_for`` finds ``H100`` by its name and raises for a name it
    does not know (the reference falls back to ``TPU_V5E``);
  * tables live under ``$REPRO_TORCH_TUNE_DIR`` or ``.repro_torch_tune``.

``verify_attention`` is never tuned on its own: it inherits the tuned
``paged_attention`` page size per layer, because both stream the SAME
paged KV pool.  The tuner reaches plan resolution through a context
variable: ``ServingEngine(autotune=...)`` enters ``use_tuner`` around its
plan resolution and its dispatches, and ``core.stream_plan.plan_for``
consults ``active_tuner()`` after the cached base build.  ``tune_plan``
memoizes per (config, shape, mesh), and candidate evaluation is
deterministic (sorted lattice order, strict-min ties keep the first
candidate), so a warm table yields bit-identical plans on every start.
"""

from __future__ import annotations

import importlib
import itertools
import os
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, replace
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.platforms import PLATFORMS, Platform
from ..core.stream_plan import KernelChoice, StreamPlan
from ..kernels.common import DeviceLike, pick_block, resolve_device
from ..obs import NULL_RECORDER, TRACK_TUNE, TUNE_MEASURE, TUNE_PRUNE
from .measure import analytic_estimate, measure_candidate
from .table import TuneEntry, TuneTable, backend_fingerprint, make_key

# Environment override for where ``autotune=True`` engines keep their
# tables; one JSON file per arch (keys inside carry quant/mesh/shape).
TUNE_DIR_ENV = "REPRO_TORCH_TUNE_DIR"
DEFAULT_TUNE_DIR = ".repro_torch_tune"

# implementation -> the kernel module declaring its lattice.
_FAMILY_MODULES = {
    "rmsnorm_matmul": "rmsnorm_matmul", "block_matmul": "block_matmul",
    "flash_attention": "flash_attention",
    "paged_attention": "paged_attention",
    "streamed_ffn": "streamed_ffn", "streamed_mlp": "streamed_ffn",
    "moe_experts": "moe_experts", "mamba2_scan": "mamba2_scan",
    "rwkv6_wkv": "rwkv6_wkv", "streamed_xent": "streamed_xent",
}


def default_table_path(cfg: ModelConfig) -> str:
    d = os.environ.get(TUNE_DIR_ENV, DEFAULT_TUNE_DIR)
    return os.path.join(d, f"{cfg.name}.json")


def _module(impl: str):
    """The family module (``importlib``: the package re-exports shadow the
    module names with the wrapper functions)."""
    return importlib.import_module(
        f"repro_torch.kernels.{_FAMILY_MODULES[impl]}")


def _tune_spaces() -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """implementation name -> candidate lattice, from the family modules.
    verify_attention inherits decode_attn's tuned page size (the shared
    pool): see ``_sync_verify_pages``."""
    out = {impl: _module(impl).TUNE_SPACE for impl in _FAMILY_MODULES}
    out["verify_attention"] = {}
    return out


def card_blocks(impl: str, dtype: str) -> Tuple[str, ...]:
    """The block names of ``impl`` that change what the card runs at the
    compute ``dtype`` (the family module's ``CARD_BLOCKS``)."""
    if impl == "verify_attention":
        impl = "paged_attention"
    if impl not in _FAMILY_MODULES:
        return ()
    return tuple(_module(impl).CARD_BLOCKS[dtype])


def _on_card(device: DeviceLike) -> bool:
    return device is None or torch.device(device).type == "cuda"


def _platform_for(plan: StreamPlan) -> Platform:
    for p in PLATFORMS.values():
        if p.name == plan.platform:
            return p
    key = str(plan.platform).lower().replace("-", "_")
    if key in PLATFORMS:
        return PLATFORMS[key]
    raise ValueError(f"plan platform {plan.platform!r} is none of "
                     f"{sorted(p.name for p in PLATFORMS.values())}; pass "
                     "platform= to tune_plan")


def _block_extents(cfg: ModelConfig, plan: StreamPlan, stage: str,
                   choice: KernelChoice) -> Dict[str, int]:
    """Extent each tunable block clips against, for candidate dedup."""
    t = max(1, plan.tokens)
    s = max(1, plan.kv_len)
    if stage == "qkv":
        return {"block_t": t, "block_n": min(cfg.q_dim, cfg.kv_dim)}
    if stage == "attention":
        return {"block_q": t, "block_kv": s}
    if stage == "ffn":
        if choice.implementation == "moe_experts":
            return {"block_t": t}
        return {"block_t": t, "block_f": cfg.d_ff}
    if stage == "mixer":
        return {"chunk": t}
    if stage == "lm_head":
        return {"block_t": t, "block_v": cfg.vocab_size}
    return {}       # page_size is a raw streaming granule, no clip


def _signature(cfg: ModelConfig, plan: StreamPlan, stage: str,
               cand: KernelChoice, device: DeviceLike = None
               ) -> Tuple[Tuple[str, int], ...]:
    """Effective-block identity: two lattice points that run the same
    program collapse to one candidate.  On the CPU the reference's clip
    identity (every block after ``pick_block``); on the card (``device``
    None or cuda) only the names in the family's ``CARD_BLOCKS``."""
    ext = _block_extents(cfg, plan, stage, cand)
    keep = (set(card_blocks(cand.implementation, cfg.dtype))
            if _on_card(device) else None)
    return tuple(
        (name, pick_block(max(1, ext[name]), max(1, int(val)))
         if name in ext else int(val))
        for name, val in cand.blocks if keep is None or name in keep)


def _shape_ctx(cfg: ModelConfig, plan: StreamPlan
               ) -> Tuple[Tuple[str, int], ...]:
    """Op-shape context baked into every table key: all dims a candidate
    kernel's program can depend on."""
    return (("t", max(1, plan.tokens)), ("s", max(1, plan.kv_len)),
            ("d", cfg.d_model), ("n", min(cfg.q_dim, cfg.kv_dim)),
            ("f", cfg.d_ff), ("v", cfg.vocab_size),
            ("h", cfg.num_heads), ("hkv", cfg.num_kv_heads))


def enumerate_candidates(cfg: ModelConfig, plan: StreamPlan, stage: str,
                         choice: KernelChoice,
                         device: DeviceLike = None) -> List[KernelChoice]:
    """Deduped candidate list for one stage, the original choice first,
    for ``device`` (None: the card).

    Candidates vary only the block names the family's ``TUNE_SPACE``
    declares; flags (``fuse_norm``, ``w8``) and the sharding claim are
    carried through unchanged: tuning never changes kernel math, only
    stream granularity.
    """
    space = _tune_spaces().get(choice.implementation, {})
    have = dict(choice.blocks)
    names = sorted(n for n in space if n in have)
    out: List[KernelChoice] = [choice]
    seen = {_signature(cfg, plan, stage, choice, device)}
    for combo in itertools.product(*(sorted(space[n]) for n in names)):
        override = dict(zip(names, combo))
        blocks = tuple((n, override.get(n, v)) for n, v in choice.blocks)
        cand = replace(choice, blocks=blocks)
        sig = _signature(cfg, plan, stage, cand, device)
        if sig in seen:
            continue
        seen.add(sig)
        out.append(cand)
    return out


def _sync_verify_pages(plan: StreamPlan) -> StreamPlan:
    """verify_attn inherits decode_attn's (tuned) page size per layer:
    the speculative verify window streams the SAME paged pool."""
    for kind, lp in plan.layers:
        if not (lp.verify_attn.fused and lp.decode_attn.fused):
            continue
        ps = lp.decode_attn.block("page_size", 16)
        if lp.verify_attn.block("page_size") == ps:
            continue
        blocks = tuple((n, ps if n == "page_size" else v)
                       for n, v in lp.verify_attn.blocks)
        plan = plan.with_stage(kind, "verify_attn", replace(
            lp.verify_attn, blocks=blocks, source=lp.decode_attn.source))
    return plan


@dataclass
class TunerStats:
    """Per-tuner counters (the table itself counts hits/misses)."""
    measured: int = 0       # candidate evaluations NOT served from table
    pruned: int = 0         # lattice points rejected by the kernel lint
    candidates: int = 0     # deduped lattice points considered
    stages: int = 0         # fused stages tuned


class Tuner:
    """Stage-level autotuner over one ``TuneTable``, for one device.

    ``mode``:
      * ``"hybrid"``   (default): table hits are reused, misses are
        measured (on the CPU: analytically scored) and filled in.
      * ``"measured"``: only table entries are trusted; a candidate the
        table has never seen is skipped, and a stage with no scored
        candidate keeps its analytic choice.
      * ``"analytic"``: score everything with the surrogate, touch the
        table not at all (A/B baseline).

    ``device``: where candidates are timed, which backend the table
    describes and which cases the lint refuses; None is the card (raises
    where there is none), except that a given ``TuneTable`` scored on the
    CPU (``cpu:plain``) makes a CPU tuner.  A table of another backend
    than the device's is refused.
    """

    def __init__(self, table=None, *, mode: str = "hybrid",
                 force_measure: bool = False, autosave: bool = True,
                 device: DeviceLike = None):
        if mode not in ("hybrid", "measured", "analytic"):
            raise ValueError(f"unknown tuner mode {mode!r} "
                             "(hybrid | measured | analytic)")
        if (device is None and isinstance(table, TuneTable)
                and table.backend == backend_fingerprint("cpu")):
            device = "cpu"
        self.device = resolve_device(device)
        backend = backend_fingerprint(self.device)
        if table is None:
            table = TuneTable(backend=backend)
        elif isinstance(table, (str, os.PathLike)):
            table = TuneTable.load(os.fspath(table), device=self.device)
        elif table.backend != backend:
            raise ValueError(f"tune table of backend {table.backend!r} "
                             f"given to a tuner on {backend!r}")
        self.table = table
        self.mode = mode
        self.force_measure = force_measure
        self.autosave = autosave
        self.stats = TunerStats()
        self._memo: Dict[object, StreamPlan] = {}
        # Telemetry recorder (obs/events.py): measure/prune instants on
        # the "tune" track.  The engine rebinds this to its own recorder.
        self.obs = NULL_RECORDER

    # ------------------------------------------------------------ plans
    def tune_plan(self, cfg: ModelConfig, plan: StreamPlan, *,
                  mesh=None, platform: Optional[Platform] = None
                  ) -> StreamPlan:
        """Tuned copy of ``plan`` (memoized per config + shape + mesh)."""
        key = (cfg, plan.tokens, plan.kv_len, plan.mesh_axes)
        got = self._memo.get(key)
        if got is not None:
            return got
        plat = platform or _platform_for(plan)
        tuned = plan
        sources: List[str] = []
        for kind, stage, choice in list(plan.stage_choices()):
            if not choice.fused or stage == "verify_attn":
                continue
            best = self._tune_stage(cfg, tuned, kind, stage, choice, plat)
            if best is None:
                continue
            tuned = tuned.with_stage(kind, stage, best)
            sources.append(best.source)
            self.stats.stages += 1
        tuned = _sync_verify_pages(tuned)
        # Provenance is about where the NUMBERS came from, not whether the
        # tuner ran: all-surrogate tuning stays "analytic"; any measured
        # stage makes the plan "hybrid"; all-measured makes it "measured".
        if sources and any(s == "measured" for s in sources):
            cost = ("measured" if all(s == "measured" for s in sources)
                    else "hybrid")
            tuned = replace(tuned, cost_source=cost)
        if (self.autosave and self.table.path and self.table.dirty
                and not self.table.frozen):
            self.table.save()
        self._memo[key] = tuned
        return tuned

    # ----------------------------------------------------------- stages
    def _legal(self, cfg: ModelConfig, plan: StreamPlan, kind: str,
               stage: str, cand: KernelChoice,
               platform: Platform) -> bool:
        """The kernel lint as the pruning oracle: the candidate must draw
        ZERO error/warning diagnostics at its own stage on the tuner's
        device.  A page size is the verify stage's too (it inherits
        decode's), so a decode candidate must also leave that stage clean:
        the verify kernel's rows grow with the page (the widest window)."""
        from ..analysis.kernel_lint import check_kernels
        swapped = plan.with_stage(kind, stage, cand)
        where = {f"{kind}.{stage}"}
        if stage == "decode_attn":
            swapped = _sync_verify_pages(swapped)
            where.add(f"{kind}.verify_attn")
        return not any(d.severity in ("error", "warning")
                       and d.stage in where
                       for d in check_kernels(swapped, cfg, platform,
                                              device=self.device.type))

    def _score(self, cfg: ModelConfig, plan: StreamPlan, kind: str,
               stage: str, cand: KernelChoice, platform: Platform
               ) -> Optional[Tuple[float, str]]:
        if self.mode == "analytic":
            return analytic_estimate(cfg, plan, stage, cand, platform), \
                "analytic"
        key = make_key(cand.implementation, shape=_shape_ctx(cfg, plan),
                       dtype=cfg.dtype, quant=cfg.quant,
                       mesh_axes=plan.mesh_axes, blocks=cand.blocks)
        entry = self.table.get(key)
        if entry is not None:
            return entry.latency_s, entry.source
        if self.mode == "measured":
            return None         # trust the table only: unseen = skipped
        latency, source = measure_candidate(
            cfg, plan, kind, stage, cand, platform=platform,
            device=self.device, force=self.force_measure)
        self.stats.measured += 1
        if self.obs.enabled:
            self.obs.instant(TUNE_MEASURE, track=TRACK_TUNE,
                             impl=cand.implementation, stage=stage,
                             latency_s=latency, source=source)
        if not self.table.frozen:
            self.table.put(key, TuneEntry(latency_s=latency,
                                          source=source))
        return latency, source

    def _tune_stage(self, cfg: ModelConfig, plan: StreamPlan, kind: str,
                    stage: str, choice: KernelChoice,
                    platform: Platform) -> Optional[KernelChoice]:
        cands = enumerate_candidates(cfg, plan, stage, choice, self.device)
        self.stats.candidates += len(cands)
        best: Optional[KernelChoice] = None
        best_lat = float("inf")
        best_src = "analytic"
        for i, cand in enumerate(cands):
            # The original choice (i == 0) is never pruned: it is the
            # fallback the plan already committed to.  On the card one the
            # lint refuses is scored without a launch.
            legal = ((i == 0 and self.device.type == "cpu")
                     or self._legal(cfg, plan, kind, stage, cand, platform))
            if i > 0 and not legal:
                self.stats.pruned += 1
                if self.obs.enabled:
                    self.obs.instant(TUNE_PRUNE, track=TRACK_TUNE,
                                     impl=cand.implementation, stage=stage)
                continue
            if legal:
                scored = self._score(cfg, plan, kind, stage, cand, platform)
            else:
                scored = (analytic_estimate(cfg, plan, stage, cand,
                                            platform), "analytic")
            if scored is None:
                continue
            lat, src = scored
            if lat < best_lat:      # strict: ties keep the earlier point
                best, best_lat, best_src = cand, lat, src
        if best is None:
            return None
        return replace(best, source=best_src)


# --------------------------------------------------------------------- #
# Context plumbing
# --------------------------------------------------------------------- #

_ACTIVE_TUNER: ContextVar[Optional[Tuner]] = ContextVar(
    "repro_torch_active_tuner", default=None)


def active_tuner() -> Optional[Tuner]:
    """The tuner the enclosing ``use_tuner`` installed, or None."""
    return _ACTIVE_TUNER.get()


@contextmanager
def use_tuner(tuner: Optional[Tuner]) -> Iterator[Optional[Tuner]]:
    """Install ``tuner`` for plan resolution within the dynamic extent
    (None is a no-op, so callers need not branch)."""
    token = _ACTIVE_TUNER.set(tuner)
    try:
        yield tuner
    finally:
        _ACTIVE_TUNER.reset(token)


def resolve_tuner(spec, cfg: ModelConfig,
                  device: DeviceLike = None) -> Optional[Tuner]:
    """Engine-facing spec resolution for ``ServingEngine(autotune=...)``,
    the tuner on ``device`` (None: the card):

      * ``None`` / ``False``   -> no tuner
      * ``True``               -> persistent table at the default path
                                  (``$REPRO_TORCH_TUNE_DIR`` or
                                  ``.repro_torch_tune``)
      * ``str``                -> table file (``*.json``) or directory
      * ``TuneTable`` / ``Tuner`` -> used as given
    """
    if spec is None or spec is False:
        return None
    if isinstance(spec, Tuner):
        return spec
    if isinstance(spec, TuneTable):
        return Tuner(spec, device=device)
    if spec is True:
        path = default_table_path(cfg)
    elif isinstance(spec, (str, os.PathLike)):
        path = os.fspath(spec)
        if not path.endswith(".json"):
            path = os.path.join(path, f"{cfg.name}.json")
    else:
        raise TypeError(f"autotune= accepts bool, path, TuneTable, or "
                        f"Tuner; got {type(spec).__name__}")
    return Tuner(TuneTable.load(path, device=device), device=device)
