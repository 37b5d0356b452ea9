"""Serving engine: continuous batching over paged KV or a contiguous slot
cache, with chunked or whole-prompt prefill, the prefix cache and
self-speculative decoding.

Port of ``repro.serving.engine``.  Requests are
admitted to cache slots one by one the moment a slot frees up, in the
order ``admission`` picks (FIFO, shortest prompt first, or longest cached
prefix first).  With ``chunked`` (the default), prompts are prefilled in
fixed-size, page-aligned chunks (``prefill_chunk``, by default the plan's
attention ``block_q``, rounded up to whole pages and clamped to a slot's
table extent) and a token-budget scheduler hands each pass prefill
chunks, a decode block, or both.  The page size is ``page_size``, by
default the plan's KV stream granule (16 on the eager plan), clamped to
``max_len``.  With ``chunked=False`` each admitted
prompt is prefilled whole, at its own length, and its fresh K/V placed
into the slot's pages (a Mamba2 stack's SSM state and conv tail into the
slot's rows) before the slot joins decode.  A stack with recurrent state
(zamba2, rwkv6) or M-RoPE positions (qwen2-vl) cannot be chunked:
``chunked`` defaults to whole-prompt there and the prefix cache, which
shares pages at chunk granularity, to off; nor can such a stack verify
speculatively.
An attention-free stack (rwkv6) has no K/V pools: its slots hold only the
recurrent state rows, and a KV quant mode is refused.

``paged=False`` keeps the contiguous slot cache (``models.init_cache``:
``slots x max_len`` K/V rows per attention layer, in the config's
``kv_cache_layout``, beside the state rows) under the same scheduler:
whole-prompt prefill, the slot's rows placed, then decode blocks of
``decode_step`` without a page table, whose attention is the plain
``decode_attention`` on every plan, as in the reference.  It refuses what
the reference refuses there: a KV quant mode, chunked prefill and
speculative decoding; the prefix cache, which needs chunks, is off.
``kv_bytes_reserved`` is the pools' size (paged) or the worst-case rows
(contiguous).

Prefix cache (DESIGN.md §10), on by default whenever prefill is chunked:
admission walks a radix tree over whole KV pages (``prefix_cache.py``),
claims every cached page of the prompt's prefix into the slot's table row
and prefills only the rest; a slot's full prompt pages enter the tree when
its prefill completes and stay cached after it exits, until memory
pressure evicts them.  ``prefix_bootstrap`` also claims the partial tail
page and serves a fully cached prompt through decode alone, copying the
shared last page (copy-on-write) before the first append.

A decode block runs ``decode_block`` steps for all slots with the sampled
tokens kept on the device and read back once per block (the reference runs the
block as one ``lax.scan``).  With ``adaptive_decode_block`` the block scales
with the slots decoding, in power-of-two steps up to 4x, pulled back by the
``decode_eff`` EMA of useful ticks (``_decode_block_size``).  With
``speculative`` the decode block is replaced by draft-then-verify (DESIGN.md
§11): each pass drafts up to ``draft_len`` tokens per slot on the host (the
prefix tree's continuations, then n-gram lookup over the slot's own history),
scores ``[pending, drafts]`` with one ``verify_step`` dispatch, keeps the
drafts while they equal the model's own greedy argmax (so outputs equal the
plain engine's) and rolls the slot's page extent back over the rejected tail.
Window widths snap to a ladder of at most three rungs.

Idle slots and slots parked mid-prefill ride along in decode and verify
with their write position at the table extent (their writes go to the
NULL page) and length 0; their outputs are discarded.

Quantized serving (DESIGN.md §14): ``quant=`` replaces the config's quant
mode for this engine.  KV modes store the page pools as int8 / fp8 codes
with per-(page, KV head) scales; weight modes run the kernel plan's w8
stages on int8 weights, quantized once when the engine is built.

Requests carry lifecycle stamps on the engine's clock: ``ttft_s``,
``latency_s``, ``queue_wait_s`` and ``tpot_s`` are ``nan`` until their
stamps exist; a request rejected at admission has a finite ``latency_s``
and a ``nan`` ``ttft_s``.

Telemetry (DESIGN.md §17, ``repro_torch.obs``): ``telemetry=`` is
None/False (the inert ``NULL_RECORDER``), True (a fresh ``Recorder``) or a
``Recorder``; ``clock=`` injects the clock that both the recorder and the
request stamps read.  The engine, its allocator and its prefix cache emit
the reference's request-lifecycle, dispatch, page and prefix events, each
site behind ``obs.enabled``.  Every number lives in a typed ``Registry``
(``self.registry``: counters, gauges, infos and the latency histograms
``ttft_s``, ``tpot_s``, ``queue_wait_s``, ``chunk_latency_s``,
``prefill_dispatch_s``, ``decode_dispatch_s``, ``verify_dispatch_s``);
``self.metrics`` is its live read-only lifetime view and
``snapshot("lifetime" | "last_generate")`` materializes either view, the
window opening at the top of each ``generate``.  Telemetry adds no
synchronization: a dispatch span ends at the read-back that already syncs
(whole-prompt prefill, the final chunk, decode blocks, verify), or right
after the launch for a chunk that is not the prompt's last.  That chunk's
span opens before its inputs are copied to the card, and a blocking copy
from pageable host memory waits for the stream: the span holds the device
work still queued (the previous chunk's) as well as the enqueue, and does
not tell the two apart.

Before anything is allocated, the engine verifies its plan statically
(``verify=``, else ``REPRO_VERIFY``, else ``"strict"``: the reference's
hook, ``analysis.verify_plan`` for the engine's device); the ``verified``
gauge and ``plan.summary()`` record the outcome.  Left for later slices:
autotuning and meshes (their metrics are registered and hold what the
reference's hold with them off).
The reference's trace probes (``prefill_traces``, ``decode_traces``,
``verify_traces``) count jit programs built; the port builds no per-shape
programs, so they stay 0 and no ``trace.*`` event is emitted.
"""

from __future__ import annotations

import os
import time
import warnings
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis import PlanVerificationError, verify_plan
from ..analysis import errors as diag_errors
from ..configs.base import ModelConfig
from ..kernels.common import DeviceLike, cdiv, resolve_device
from ..kernels.ref import code_view
from ..models.model import (decode_step, prefill, prefill_chunk,
                            resolve_plan, supports_chunked_prefill,
                            supports_speculative, verify_step)
from ..models.params import (cache_leaf_kind, has_kv_pools, init_cache,
                             kv_seq_axis, quantize_weights)
from ..obs import (DISPATCH_DECODE, DISPATCH_PREFILL, DISPATCH_PREFILL_CHUNK,
                   DISPATCH_VERIFY, REQ_ADMITTED, REQ_FINISHED,
                   REQ_FIRST_TOKEN, REQ_PREFILL_CHUNK, REQ_QUEUED,
                   REQ_REJECTED, SCHED_BUDGET, TRACK_ENGINE, TRACK_SCHED,
                   MetricsView, Registry, resolve_recorder, slot_track)
from .kv_cache import NULL_PAGE, PagedKVCache, place_prefill, stage_chunk
from .prefix_cache import PrefixCache

Tree = Any

# Counters (accumulate over the engine's life), in the order and with the
# help strings the reference registers them (``engine.py:590-616``).  The
# trace probes and the tuner's counters are registered so that the key sets
# are equal, and stay 0: the port builds no per-shape programs and has no
# autotuner yet.
COUNTERS = (
    ("dispatches", "decode+verify dispatches (not prefill)"),
    ("ticks", "useful decode scan ticks (max per dispatch)"),
    ("scan_ticks", "total decode scan ticks incl. wasted tail"),
    ("generated", "tokens delivered to requests"),
    ("prefills", "prompt prefills completed (incl. final chunk)"),
    ("prefill_chunks", "chunked-prefill dispatches"),
    ("rejected", "requests failed at admission or allocation"),
    ("prefill_traces", "prefill programs BUILT (trace probe; 0: the port "
                       "builds no per-shape programs)"),
    ("decode_traces", "decode programs BUILT (trace probe; 0: the port "
                      "builds no per-shape programs)"),
    ("verify_traces", "verify programs BUILT (trace probe; 0: the port "
                      "builds no per-shape programs)"),
    ("prefix_hit_pages", "prompt pages served from prefix cache"),
    ("prompt_pages", "prompt pages needed by admitted requests"),
    ("cow_copies", "copy-on-write page copies"),
    ("prefix_bootstraps", "fully-cached prompts decode-bootstrapped"),
    ("prefix_evictions", "pages evicted from the prefix cache"),
    ("draft_tokens", "speculative draft tokens proposed"),
    ("accepted_tokens", "draft tokens accepted by verify"),
    ("spec_tokens", "tokens delivered by speculative dispatches"),
    ("verify_dispatches", "speculative verify dispatches"),
    ("rollbacks", "KV extent rollbacks after rejected drafts"),
    ("rollback_pages", "pages freed by rollbacks"),
    ("tune_hits", "tune-table lookups served"),
    ("tune_misses", "tune-table lookups missed"),
    ("tune_measured", "tuner measurement dispatches"),
    ("tune_pruned", "tuner candidates pruned by lint"),
)
# The counters the port's engine moves.
COUNTER_NAMES = tuple(n for n, _ in COUNTERS
                      if not n.endswith("_traces") and not
                      n.startswith("tune_"))
# Latency distributions: request-level TTFT / TPOT / queue wait, and the
# wall of each dispatch kind.
HISTOGRAMS = (
    ("ttft_s", "time to first token"),
    ("tpot_s", "time per output token after the first"),
    ("queue_wait_s", "submit-to-admission wait"),
    ("chunk_latency_s", "prefill-chunk dispatch wall"),
    ("prefill_dispatch_s", "whole-prompt prefill dispatch wall"),
    ("decode_dispatch_s", "decode-block dispatch wall"),
    ("verify_dispatch_s", "verify dispatch wall"),
)
ADMISSION = ("fifo", "sjf", "prefix")


def _ngram_continuation(hist: np.ndarray, k: int) -> List[int]:
    """Prompt-lookup drafting (``engine.py:206``): find the most recent
    earlier occurrence of the history's trailing n-gram (n = 3, then 2)
    and return up to ``k`` of the tokens that followed it."""
    n_tok = int(hist.shape[0])
    for n in (3, 2):
        if n_tok <= n:
            continue
        tail = hist[-n:]
        # Windows over hist[:-1] end before the last token, so the
        # trailing n-gram never matches itself.
        win = np.lib.stride_tricks.sliding_window_view(hist[:-1], n)
        hits = np.nonzero((win == tail[None, :]).all(axis=1))[0]
        if hits.size:
            i = int(hits[-1])
            return [int(t) for t in hist[i + n:i + n + k]]
    return []


def _place_cache_slot(cache: Dict[str, torch.Tensor],
                      fresh: Dict[str, torch.Tensor], slot: int,
                      layout: str) -> None:
    """Write a batch-1 prefill cache into one slot of the contiguous cache,
    in place (``engine.py:226``): K/V fill the slot's first S positions
    along the layout's sequence axis, state leaves replace the slot's
    row.  An unregistered leaf raises (``cache_leaf_kind``)."""
    ax = kv_seq_axis(layout)
    for name, small in fresh.items():
        row = cache[name][:, slot]
        if cache_leaf_kind(name) == "state":
            row.copy_(small[:, 0])
        else:
            row.narrow(ax, 0, small.shape[ax]).copy_(small[:, 0])


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # [S] int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    failed: bool = False
    error: Optional[str] = None
    prefill_pos: int = 0            # prompt tokens already prefilled
    # Lifecycle stamps on the engine's clock; 0.0 = has not happened.
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0

    @property
    def ttft_s(self) -> float:
        """Time to first token; nan until a first token exists."""
        if self.first_token_at <= 0.0 or self.submitted_at <= 0.0:
            return float("nan")
        return self.first_token_at - self.submitted_at

    @property
    def latency_s(self) -> float:
        """Submit-to-finish time; nan until the request finished (a request
        rejected at admission finished then)."""
        if self.finished_at <= 0.0 or self.submitted_at <= 0.0:
            return float("nan")
        return self.finished_at - self.submitted_at

    @property
    def queue_wait_s(self) -> float:
        """Submit-to-admission wait; nan until the request takes a slot
        (a rejected request never does)."""
        if self.admitted_at <= 0.0 or self.submitted_at <= 0.0:
            return float("nan")
        return self.admitted_at - self.submitted_at

    @property
    def tpot_s(self) -> float:
        """Time per output token after the first; nan with fewer than two
        tokens or before the request finished."""
        n = len(self.out_tokens)
        if (n < 2 or self.finished_at <= 0.0
                or self.first_token_at <= 0.0):
            return float("nan")
        return (self.finished_at - self.first_token_at) / (n - 1)


class ServingEngine:
    """Continuously-batched greedy generation over a fixed slot count."""

    def __init__(self, cfg: ModelConfig, params: Tree, *,
                 batch_slots: int = 4, max_len: int = 256,
                 decode_block: int = 16, paged: bool = True,
                 page_size: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 chunked: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_bootstrap: bool = False, admission: str = "fifo",
                 adaptive_decode_block: bool = False,
                 speculative: bool = False, draft_len: int = 4,
                 quant: Optional[str] = None, telemetry=None, clock=None,
                 verify: Optional[str] = None,
                 device: DeviceLike = None):
        # ``quant`` replaces the config's quant mode for this engine
        # (``engine.py:256-267``); the plan and the pool dtypes follow it.
        if quant is not None and quant != cfg.quant:
            cfg = replace(cfg, quant=quant)
        if cfg.kv_quant and not paged:
            raise ValueError("KV quantization requires the paged cache "
                             "(per-page scale pools ride next to the "
                             "page pools)")
        if cfg.kv_quant and not has_kv_pools(cfg):
            raise ValueError(
                f"config {cfg.name!r} has no K/V pools to quantize "
                f"(quant={cfg.quant!r}): an attention-free stack serves "
                "'none' or 'w8'")
        if admission not in ADMISSION:
            raise ValueError(f"unknown admission policy {admission!r} "
                             "(fifo | sjf | prefix)")
        self.admission = admission
        self.adaptive_decode_block = bool(adaptive_decode_block)
        self.paged = bool(paged)
        # None: chunked whenever the cache is paged and the config supports
        # it (``engine.py:367``); a recurrent-state stack (zamba2, rwkv6)
        # or an M-RoPE one (qwen2-vl) admits whole prompts.
        if chunked is None:
            chunked = paged and supports_chunked_prefill(cfg)
        if chunked and not paged:
            raise ValueError("chunked prefill requires the paged cache "
                             "(chunks carry between dispatches in the "
                             "page pools)")
        if chunked and not supports_chunked_prefill(cfg):
            raise ValueError(
                f"config {cfg.name!r} does not support chunked prefill "
                "(SSM/RWKV state or mrope positions)")
        self.chunked = bool(chunked)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.slots = batch_slots
        self.max_len = max_len
        self.decode_block = max(1, decode_block)
        # One timebase: the recorder's spans and the request stamps read
        # the same clock (``engine.py:295-302``).
        self.obs = resolve_recorder(telemetry, clock=clock)
        self.clock = (clock if clock is not None
                      else (self.obs.clock if self.obs.enabled
                            else time.perf_counter))
        # EMA of the per-dispatch useful-tick fraction: the prefill
        # budget's and the adaptive decode block's pressure signal (1.0 =
        # every tick useful).
        self.decode_eff = 1.0
        # One plan drives both stream granules: the KV page size and the
        # prefill chunk (a whole number of pages).  None when eager.
        self.plan = resolve_plan(cfg, batch_slots, kv_len=max_len)
        if page_size is None:
            page_size = (self.plan.decode_page_size(16)
                         if self.plan is not None else 16)
        # Static verification (``engine.py:337-365``): the stream verifier
        # runs over the plan, the pool schema and the dispatch effect
        # signatures, for this engine's device, before anything is
        # allocated or launched.  "strict" (the default) refuses a plan
        # with error diagnostics, "warn" reports them and goes on, "off"
        # skips; the plan records the outcome.
        vmode = (verify if verify is not None
                 else os.environ.get("REPRO_VERIFY", "strict"))
        if vmode not in ("strict", "warn", "off"):
            raise ValueError(f"unknown verify mode {vmode!r} "
                             "(strict | warn | off)")
        self.verify_mode = vmode
        if vmode != "off" and self.plan is not None:
            diags = verify_plan(
                self.plan, cfg, slots=batch_slots if paged else None,
                max_len=max_len if paged else None,
                page_size=min(page_size, max_len) if paged else None,
                device=self.device.type)
            errs = diag_errors(diags)
            self.plan = self.plan.with_verification(
                not errs, tuple(str(d) for d in diags))
            if errs:
                if vmode == "strict":
                    raise PlanVerificationError(diags)
                warnings.warn("StreamPlan failed static verification: "
                              + "; ".join(str(d) for d in errs))
        # The plan's w8 stages read int8 codes quantized here, once.
        self.params = quantize_weights(cfg, params)

        # Self-speculative decoding: the plan clamps the verify window to
        # its KV page granule (``engine.py:379-408``).
        self.draft_len = int(draft_len)
        if speculative:
            if not paged:
                raise ValueError("speculative decoding requires the paged "
                                 "cache (rejection rolls back the slot's "
                                 "page-table extent)")
            if not supports_speculative(cfg):
                raise ValueError(
                    f"config {cfg.name!r} does not support speculative "
                    "decoding (recurrent state cannot roll back)")
            if self.draft_len < 1:
                raise ValueError("draft_len must be >= 1")
            if self.plan is not None:
                self.draft_len = min(
                    self.draft_len,
                    self.plan.verify_window(self.draft_len) - 1)
        self.speculative = bool(speculative)
        # Verify-window ladder: per-pass widths snap up to at most three
        # rungs instead of tracking the exact draft count.
        self._w_ladder = tuple(sorted(
            {2, self.draft_len // 2 + 1, self.draft_len + 1} - {0, 1}))
        # Tests turn this on to audit the allocator after every rollback.
        self._debug_check_pages = False

        self.kv: Optional[PagedKVCache] = None
        if paged:
            self.kv = PagedKVCache(cfg, slots=batch_slots, max_len=max_len,
                                   page_size=page_size, device=self.device,
                                   obs=self.obs)
            self.cache = self.kv.init_cache()
        else:
            self.cache = init_cache(cfg, batch_slots, max_len,
                                    device=self.device)
        if self.chunked:
            ps = self.kv.page_size
            # The plan's prefill granule, or the override, rounded up to
            # whole pages and clamped to the table extent (``:524-531``).
            want = (prefill_chunk if prefill_chunk is not None
                    else (self.plan.prefill_chunk_size(ps)
                          if self.plan is not None else 4 * ps))
            want = cdiv(max(1, int(want)), ps) * ps
            self.chunk = max(ps, min(want, self.kv.extent))
        else:
            self.chunk = 0

        # Prefix cache: on by default whenever prefill is chunked
        # (``engine.py:556-569``); chunk-aligned matching keeps greedy
        # tokens bit-identical to a cold engine.
        if prefix_cache is None:
            prefix_cache = self.chunked
        if prefix_cache and not self.chunked:
            raise ValueError("prefix_cache requires chunked prefill "
                             "(pages are shared at chunk granularity)")
        if prefix_bootstrap and not prefix_cache:
            raise ValueError("prefix_bootstrap requires prefix_cache")
        if admission == "prefix" and not prefix_cache:
            raise ValueError('admission="prefix" requires prefix_cache')
        self.prefix: Optional[PrefixCache] = None
        if prefix_cache:
            self.prefix = PrefixCache(self.kv, chunk=self.chunk,
                                      bootstrap=prefix_bootstrap,
                                      obs=self.obs)
        # Pending copy-on-write per slot: the logical page whose next
        # write must swap in a private copy.
        self._cow: List[Optional[int]] = [None] * batch_slots
        # Reserved K/V bytes: the pools (paged) or the worst-case slot
        # rows (contiguous), scale pools included (``engine.py:575-580``).
        self.kv_bytes_reserved = sum(
            t.numel() * t.element_size() for name, t in self.cache.items()
            if cache_leaf_kind(name) in ("kv", "scale"))
        # Typed metric registry (DESIGN.md §17), declared in the
        # reference's order (``engine.py:590-667``); ``metrics`` is its live
        # read-only lifetime view.
        reg = self.registry = Registry()
        for name, help in COUNTERS:
            reg.counter(name, help)
        reg.gauge("decode_block", value=self.decode_block)
        reg.gauge("paged", value=int(self.paged))
        reg.gauge("chunked", value=int(self.chunked))
        reg.gauge("prefill_chunk", value=self.chunk)
        reg.gauge("page_size",
                  value=self.kv.page_size if self.kv is not None else 0)
        reg.gauge("kv_bytes_reserved", value=self.kv_bytes_reserved)
        reg.gauge("kv_bytes_peak")
        reg.gauge("kv_bytes_cached")
        reg.info("quant", value=cfg.quant)
        reg.gauge("verified", value=int(bool(self.plan.verified))
                  if self.plan is not None else 0)
        reg.gauge("kv_itemsize_effective", value=(
            self.kv.kv_itemsize_effective if self.kv is not None
            else (2.0 if cfg.dtype == "bfloat16" else 4.0)))
        reg.gauge("sched_budget")
        # No meshes yet: one device, unsharded pools.
        reg.gauge("sharded")
        reg.gauge("kv_shards", value=1)
        reg.gauge("prefix_enabled", value=int(self.prefix is not None))
        reg.gauge("prefix_hit_rate")
        reg.gauge("prefix_cached_pages")
        reg.gauge("pages_in_use")
        reg.gauge("decode_block_last", value=self.decode_block)
        reg.gauge("speculative", value=int(self.speculative))
        reg.gauge("draft_len",
                  value=self.draft_len if self.speculative else 0)
        reg.gauge("accept_rate")
        reg.gauge("dispatches_per_token")
        # No autotuner yet: the plan's provenance is the DSE's.
        reg.info("plan_source",
                 value=(self.plan.cost_source if self.plan is not None
                        else "analytic"))
        reg.gauge("autotuned")
        reg.info("tune_table", value="")
        reg.gauge("tune_entries")
        for name, help in HISTOGRAMS:
            reg.histogram(name, help)
        self.metrics = MetricsView(reg)

    def _sync_counter(self, name: str, total: float) -> None:
        """Catch a lifetime counter up to a total kept elsewhere (the
        prefix cache's evictions); the delta lands in the current
        ``last_generate`` window."""
        c = self.registry[name]
        d = total - c.value()
        if d > 0:
            c.inc(d)

    def snapshot(self, view: str = "lifetime") -> Dict[str, Any]:
        """Materialized metrics for ``view`` (``"lifetime"`` |
        ``"last_generate"``).  The lifetime view equals
        ``dict(self.metrics)``; the windowed view recomputes the derived
        rates from the window's counters (the stored gauges are lifetime
        rates)."""
        out = self.registry.snapshot(view)
        if view == "last_generate":
            reg = self.registry
            hits = reg["prefix_hit_pages"].value(view)
            out["prefix_hit_rate"] = (
                hits / max(reg["prompt_pages"].value(view), 1))
            out["accept_rate"] = (
                reg["accepted_tokens"].value(view)
                / max(reg["draft_tokens"].value(view), 1))
            out["dispatches_per_token"] = (
                reg["verify_dispatches"].value(view)
                / max(reg["spec_tokens"].value(view), 1))
        return out

    # -------------------------------------------------------------- API
    @torch.no_grad()
    def generate(self, prompts: List[np.ndarray],
                 max_new_tokens: int = 16) -> List[Request]:
        """Serve a list of prompts (any mix of lengths) to completion."""
        self.registry.mark()        # open the ``last_generate`` window
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                        max_new_tokens=max_new_tokens,
                        submitted_at=self.clock())
                for i, p in enumerate(prompts)]
        if self.obs.enabled:
            for r in reqs:
                self.obs.instant(REQ_QUEUED, track=TRACK_SCHED,
                                 ts=r.submitted_at, rid=r.rid,
                                 plen=int(r.prompt.shape[0])
                                 if r.prompt.ndim >= 1 else 0)
        pending = deque(reqs)
        active: List[Optional[Request]] = [None] * self.slots
        decoding = [False] * self.slots     # False: idle or mid-prefill
        pos = np.zeros(self.slots, np.int32)        # == per-slot length
        tok = np.zeros((self.slots, 1), np.int32)

        while pending or any(r is not None for r in active):
            self._admit_pending(pending, active, decoding, pos, tok)
            if not any(r is not None for r in active):
                break
            progressed = False
            if self.chunked:
                budget = self._prefill_budget(active, decoding)
                for s in range(self.slots):
                    r = active[s]
                    if r is None or decoding[s]:
                        continue
                    if progressed and budget < self.chunk:
                        break       # budget spent; the rest wait a pass
                    self._dispatch_chunk(s, r, active, decoding, pos, tok)
                    budget -= self.chunk
                    progressed = True
            if any(active[s] is not None and decoding[s]
                   for s in range(self.slots)):
                if self.speculative:
                    self._speculative_block(active, decoding, pos, tok)
                else:
                    self._decode_block(active, decoding, pos, tok)
                progressed = True
            if not progressed:
                break
        reg = self.registry
        if self.kv is not None:
            reg["kv_bytes_peak"].max(self.kv.peak_bytes_in_use)
            reg["pages_in_use"].set(self.kv.pages_in_use)
        else:
            reg["kv_bytes_peak"].set(self.kv_bytes_reserved)
        if self.prefix is not None:
            # Lifetime rate: hit pages over every prompt page admitted;
            # ``snapshot("last_generate")`` recomputes it per window.
            reg["prefix_hit_rate"].set(
                reg["prefix_hit_pages"].value()
                / max(reg["prompt_pages"].value(), 1))
            self._sync_counter("prefix_evictions", self.prefix.evictions)
            reg["prefix_cached_pages"].set(self.kv.pages_cached)
            reg["kv_bytes_cached"].set(self.kv.bytes_cached)
        if self.speculative:
            reg["accept_rate"].set(
                reg["accepted_tokens"].value()
                / max(reg["draft_tokens"].value(), 1))
            reg["dispatches_per_token"].set(
                reg["verify_dispatches"].value()
                / max(reg["spec_tokens"].value(), 1))
        return reqs

    # ------------------------------------------------------- scheduling
    def _prefill_budget(self, active, decoding) -> int:
        """Prefill tokens for one pass (``engine.py:799``): one chunk per
        slot waiting on prefill, plus the decode backlog's share that the
        ``decode_eff`` EMA says decode is not using."""
        waiting = sum(1 for s in range(self.slots)
                      if active[s] is not None and not decoding[s])
        if not waiting:
            self.registry["sched_budget"].set(0)
            return 0
        backlog = sum(1 for s in range(self.slots)
                      if active[s] is not None and decoding[s])
        slack = (1.0 - self.decode_eff) * backlog
        share = min(float(self.slots), waiting + slack)
        budget = int(self.chunk * max(1.0, share))
        self.registry["sched_budget"].set(budget)
        if self.obs.enabled:
            self.obs.instant(SCHED_BUDGET, track=TRACK_SCHED,
                             budget=budget, waiting=waiting,
                             backlog=backlog,
                             decode_eff=round(self.decode_eff, 4))
        return budget

    def _next_request(self, pending, scores) -> Request:
        """Pop the next request per the admission policy (``:839``):
        ``fifo`` arrival order, ``sjf`` the shortest prompt, ``prefix`` the
        longest cached prefix; ties go to arrival order.  ``scores``
        memoises one radix walk per request per admission pass."""
        if self.admission == "fifo" or len(pending) <= 1:
            return pending.popleft()
        if self.admission == "sjf":
            idx = min(range(len(pending)),
                      key=lambda i: (int(pending[i].prompt.shape[0]), i))
        else:
            def score(i):
                r = pending[i]
                if r.rid not in scores:
                    scores[r.rid] = self.prefix.lookup_pages(r.prompt)
                return scores[r.rid]

            idx = max(range(len(pending)), key=lambda i: (score(i), -i))
        r = pending[idx]
        del pending[idx]
        return r

    def _validate(self, r: Request) -> Optional[str]:
        """A bad prompt fails at admission, never mid-dispatch."""
        plen = int(r.prompt.shape[0]) if r.prompt.ndim >= 1 else 0
        if plen == 0:
            return "empty prompt"
        if plen > self.max_len:
            return f"prompt length {plen} exceeds max_len {self.max_len}"
        return None

    def _admit_pending(self, pending, active, decoding, pos, tok) -> None:
        """Fill every free slot from the queue; invalid prompts are failed
        and skipped.  Chunked admission assigns the slot (through the
        prefix walk when the prefix cache is on) and prefill is scheduled
        chunk by chunk; whole-prompt admission prefills the prompt here."""
        scores: Dict[int, int] = {}
        for s in range(self.slots):
            while active[s] is None and pending:
                r = self._next_request(pending, scores)
                err = self._validate(r)
                if err is not None:
                    r.failed = True
                    r.error = err
                    r.done = True
                    r.finished_at = self.clock()
                    self.registry["rejected"].inc()
                    if self.obs.enabled:
                        self.obs.instant(REQ_REJECTED, track=TRACK_SCHED,
                                         ts=r.finished_at, rid=r.rid,
                                         error=err)
                    continue
                self._stamp_admitted(r, s)
                if self.chunked:
                    r.prefill_pos = 0
                    self._cow[s] = None
                    if self.prefix is not None:
                        self._admit_prefix(s, r, active, decoding, pos, tok)
                        continue
                    active[s] = r
                    decoding[s] = False
                    continue
                self._admit(s, r, pos, tok)
                if (len(r.out_tokens) >= r.max_new_tokens
                        or pos[s] >= self.max_len):
                    self._retire(s, r, active, decoding, pos, tok)
                else:
                    active[s] = r
                    decoding[s] = True

    def _stamp_admitted(self, r: Request, slot: int) -> None:
        """The request takes a slot: stamp ``admitted_at``, observe the
        queue wait, emit the lifecycle instant (``engine.py:919``)."""
        r.admitted_at = self.clock()
        self.registry["queue_wait_s"].observe(r.queue_wait_s)
        if self.obs.enabled:
            self.obs.instant(REQ_ADMITTED, track=slot_track(slot),
                             ts=r.admitted_at, rid=r.rid, slot=slot)

    def _stamp_first_token(self, r: Request, slot: int) -> None:
        """The first output token exists: stamp it, observe TTFT, emit the
        lifecycle instant (``engine.py:928``)."""
        r.first_token_at = self.clock()
        self.registry["ttft_s"].observe(r.ttft_s)
        if self.obs.enabled:
            self.obs.instant(REQ_FIRST_TOKEN, track=slot_track(slot),
                             ts=r.first_token_at, rid=r.rid,
                             ttft_s=round(r.ttft_s, 6))

    def _admit_prefix(self, slot: int, r: Request, active, decoding, pos,
                      tok) -> None:
        """Chunked admission through the prefix walk (``engine.py:939``):
        claim every cached prefix page and resume prefill at the first
        chunk not cached.  Under bootstrap a fully cached prompt skips
        prefill: its last token goes through decode, whose first append
        copy-on-writes the shared tail page."""
        hit = self.prefix.claim(slot, r.prompt)
        r.prefill_pos = hit.prefill_start
        self._cow[slot] = hit.cow
        self.registry["prefix_hit_pages"].inc(hit.hit_pages)
        self.registry["prompt_pages"].inc(hit.prompt_pages)
        active[slot] = r
        if not hit.full:
            decoding[slot] = False
            return
        plen = int(r.prompt.shape[0])
        self.prefix.insert(slot, r.prompt)      # re-stamp; nothing new
        r.prefill_pos = plen
        decoding[slot] = True
        pos[slot] = plen - 1
        tok[slot, 0] = int(r.prompt[-1])
        self.registry["prefix_bootstraps"].inc()
        self.registry["prefills"].inc()

    def _admit(self, slot: int, r: Request, pos, tok) -> None:
        """Whole-prompt prefill at the request's own length into the slot's
        pages, or its rows of the contiguous cache (``engine.py:969``);
        emits the first token."""
        plen = int(r.prompt.shape[0])
        dev = self.device
        t0 = self.clock()
        logits, fresh = prefill(self.params, self.cfg,
                                torch.as_tensor(r.prompt, device=dev)[None],
                                plan=self.plan)
        if self.kv is None:
            _place_cache_slot(self.cache, fresh, slot,
                              self.cfg.kv_cache_layout)
        else:
            pages = torch.as_tensor(self.kv.ensure(slot, plen), device=dev)
            place_prefill(self.cache, fresh, pages,
                          layout=self.cfg.kv_cache_layout, slot=slot)
        t = int(logits[0, 0].argmax())              # reads back: syncs
        dt = self.clock() - t0       # device + host wall (the read-back)
        self.registry["prefill_dispatch_s"].observe(dt)
        if self.obs.enabled:
            self.obs.complete(DISPATCH_PREFILL, t0, dt,
                              track=TRACK_ENGINE, slot=slot, rid=r.rid,
                              tokens=plen)
            self.obs.complete("prefill", t0, dt, track=slot_track(slot),
                              rid=r.rid, tokens=plen)
        r.out_tokens.append(t)
        self._stamp_first_token(r, slot)
        r.prefill_pos = plen
        pos[slot] = plen
        tok[slot, 0] = t
        self.registry["prefills"].inc()
        self.registry["generated"].inc()

    def _dispatch_chunk(self, slot: int, r: Request, active, decoding,
                        pos, tok) -> None:
        """One prefill chunk; the final chunk emits the first token and
        flips the slot to decoding.  With the prefix cache, a catch-up
        walk first claims pages that appeared since admission, and the
        final chunk indexes the prompt's full pages."""
        c = self.chunk
        plen = int(r.prompt.shape[0])
        off = r.prefill_pos
        if self.prefix is not None and self._cow[slot] is None:
            off, caught = self.prefix.extend_claim(slot, r.prompt, off)
            if caught:
                r.prefill_pos = off
                self.registry["prefix_hit_pages"].inc(caught)
        try:
            self.kv.ensure(slot, min(off + c, self.max_len))
        except RuntimeError as e:
            r.failed = True
            r.error = str(e)
            self.registry["rejected"].inc()
            self._retire(slot, r, active, decoding, pos, tok)
            return
        row = self.kv.table_row(slot)
        toks, cpages, last = stage_chunk(r.prompt, off, c, row,
                                         self.kv.page_size)
        dev = self.device
        t0 = self.clock()
        next_tok, _, _ = prefill_chunk(
            self.params, self.cfg, torch.as_tensor(toks, device=dev)[None],
            self.cache, torch.as_tensor(row, device=dev),
            torch.as_tensor(cpages, device=dev), off, last, plan=self.plan)
        final = off + c >= plen
        if final:
            t = int(next_tok[0, 0])                 # reads back: syncs
        # The final chunk's wall is device + host (its read-back); an
        # earlier chunk's ends at the launch, with no sync added, but its
        # input copies above wait for the device work still queued.
        dt = self.clock() - t0
        self.registry["chunk_latency_s"].observe(dt)
        if self.obs.enabled:
            ci = off // c
            self.obs.complete(DISPATCH_PREFILL_CHUNK, t0, dt,
                              track=TRACK_ENGINE, slot=slot, rid=r.rid,
                              chunk=ci, off=off)
            self.obs.complete("prefill_chunk", t0, dt,
                              track=slot_track(slot), rid=r.rid, chunk=ci)
            self.obs.instant(REQ_PREFILL_CHUNK, track=slot_track(slot),
                             rid=r.rid, chunk=ci, off=off)
        r.prefill_pos = min(off + c, plen)
        self.registry["prefill_chunks"].inc()
        if not final:
            return                                  # more chunks to go
        if self.prefix is not None:
            self.prefix.insert(slot, r.prompt)
        r.out_tokens.append(t)
        self._stamp_first_token(r, slot)
        pos[slot] = plen
        tok[slot, 0] = t
        decoding[slot] = True
        self.registry["prefills"].inc()
        self.registry["generated"].inc()
        if (len(r.out_tokens) >= r.max_new_tokens
                or pos[slot] >= self.max_len):
            self._retire(slot, r, active, decoding, pos, tok)

    def _retire(self, slot: int, r: Request, active, decoding, pos,
                tok) -> None:
        r.done = True
        r.finished_at = self.clock()
        if not r.failed:
            # A failed or single-token request's nan TPOT never lands.
            self.registry["tpot_s"].observe(r.tpot_s)
        if self.obs.enabled:
            self.obs.instant(REQ_FINISHED, track=slot_track(slot),
                             ts=r.finished_at, rid=r.rid,
                             tokens=len(r.out_tokens), failed=r.failed)
        active[slot] = None
        decoding[slot] = False
        pos[slot] = 0
        tok[slot, 0] = 0
        self._cow[slot] = None
        if self.prefix is not None:
            # Drop the tree's hold first (re-stamps the prefix as most
            # recently used); tree pages stay cached after the release.
            self.prefix.release_slot(slot)
        if self.kv is not None:
            self.kv.release(slot)

    def _provision(self, runnable, active, decoding, pos, tok,
                   width) -> Tuple[np.ndarray, np.ndarray]:
        """Resolve pending copy-on-write swaps and allocate each runnable
        slot's pages for ``width(slot)`` more positions.  An allocator
        failure fails that request alone.  Returns the (src, dst) page
        pairs to copy, NULL where a slot has none."""
        cow_src = np.full(self.slots, NULL_PAGE, np.int32)
        cow_dst = np.full(self.slots, NULL_PAGE, np.int32)
        for s in list(runnable):
            r = active[s]
            try:
                if self._cow[s] is not None:
                    cow_src[s], cow_dst[s] = self.kv.cow_page(s, self._cow[s])
                    self._cow[s] = None
                    self.registry["cow_copies"].inc()
                    # The slot's reference moved off the shared src page.
                    self.prefix.page_released(int(cow_src[s]))
                self.kv.ensure(s, min(int(pos[s]) + width(s), self.max_len))
            except RuntimeError as e:
                r.failed = True
                r.error = str(e)
                self.registry["rejected"].inc()
                self._retire(s, r, active, decoding, pos, tok)
                cow_src[s] = cow_dst[s] = NULL_PAGE
        return cow_src, cow_dst

    def _copy_on_write(self, cow_src: np.ndarray, cow_dst: np.ndarray
                       ) -> None:
        """Duplicate each shared page onto its private copy in every pool,
        scale pools included, before the dispatch writes (the table already
        points at dst; ``engine.py:497``)."""
        if not (cow_dst != NULL_PAGE).any():
            return
        src = torch.as_tensor(cow_src, device=self.device).long()
        dst = torch.as_tensor(cow_dst, device=self.device).long()
        for name, pool in self.cache.items():       # [L, P, ...]
            if cache_leaf_kind(name) == "state":
                continue
            raw = code_view(pool)
            raw[:, dst] = raw[:, src]

    def _decode_block_size(self, n_active: int) -> int:
        """Steps in the next decode block (``engine.py:1115``): the static
        ``decode_block``, or with ``adaptive_decode_block`` that block
        doubled once per power of two that ``n_active * decode_eff``
        reaches (at 2, then 4), at most 4x: more slots decoding usefully
        amortize the per-block read-back over more tokens, and ticks
        wasted on slots retiring mid-block pull it back."""
        if not self.adaptive_decode_block:
            return self.decode_block
        scale = n_active * max(self.decode_eff, 0.0)
        k = 0
        while k < 2 and (2 << k) <= scale:
            k += 1
        return self.decode_block << k

    def _decode_block(self, active, decoding, pos, tok) -> None:
        """A block of decode steps across all slots, each at its own
        position; tokens stay on the device until the block ends."""
        runnable = [s for s in range(self.slots)
                    if active[s] is not None and decoding[s]]
        block = self._decode_block_size(len(runnable))
        self.registry["decode_block_last"].set(block)
        dev = self.device
        if self.kv is not None:
            # Allocate only what each request's remaining budget can read
            # back: later ticks write past the allocated pages, which
            # routes them to the NULL page, and their tokens are dropped.
            cow_src, cow_dst = self._provision(
                runnable, active, decoding, pos, tok,
                lambda s: min(block, active[s].max_new_tokens
                              - len(active[s].out_tokens)))
            runnable = [s for s in runnable
                        if active[s] is not None and decoding[s]]
            if not runnable:
                return
            t0 = self.clock()
            self._copy_on_write(cow_src, cow_dst)
            dpos = np.full(self.slots, self.kv.extent, np.int32)
            dlen = np.zeros(self.slots, np.int32)
            for s in runnable:
                dpos[s] = pos[s]
                dlen[s] = pos[s]
            table = self.kv.page_table
        else:
            # Contiguous: every slot steps at its own position; an idle
            # slot writes into its own rows, which the next admission's
            # placement overwrites (``engine.py:1198-1202``).
            t0 = self.clock()
            dpos = dlen = pos.copy()
            table = None
        tok_d = torch.as_tensor(tok, device=dev)
        pos_d = torch.as_tensor(dpos, device=dev)
        len_d = torch.as_tensor(dlen, device=dev)
        steps = []
        for _ in range(block):
            tok_d, _, _ = decode_step(self.params, self.cfg, tok_d,
                                      self.cache, pos_d, len_d,
                                      page_table=table, plan=self.plan)
            steps.append(tok_d[:, 0])
            pos_d = pos_d + 1
            len_d = len_d + 1
        toks_np = torch.stack(steps).cpu().numpy()   # [block, slots]: syncs
        dt = self.clock() - t0       # device + host block wall (read-back)
        self.registry["decode_dispatch_s"].observe(dt)
        if self.obs.enabled:
            self.obs.complete(DISPATCH_DECODE, t0, dt, track=TRACK_ENGINE,
                              block=block, slots=len(runnable))
            for s in runnable:
                self.obs.complete("decode", t0, dt, track=slot_track(s),
                                  rid=active[s].rid, block=block)
        useful = 0
        for s in runnable:
            r = active[s]
            h = min(block, r.max_new_tokens - len(r.out_tokens),
                    self.max_len - int(pos[s]))
            r.out_tokens.extend(int(t) for t in toks_np[:h, s])
            if r.out_tokens and r.first_token_at <= 0.0:
                self._stamp_first_token(r, s)       # bootstrap admission
            useful = max(useful, h)
            self.registry["generated"].inc(h)
            pos[s] = min(int(pos[s]) + block, self.max_len)
            tok[s, 0] = toks_np[-1, s]
            if (len(r.out_tokens) >= r.max_new_tokens
                    or pos[s] >= self.max_len):
                self._retire(s, r, active, decoding, pos, tok)
        self.registry["dispatches"].inc()
        self.registry["ticks"].inc(useful)
        self.registry["scan_ticks"].inc(block)
        if self.kv is not None:
            self.registry["pages_in_use"].set(self.kv.pages_in_use)
        self.decode_eff = 0.5 * self.decode_eff + 0.5 * useful / block

    # ------------------------------------------------ speculative decode
    def _draft(self, r: Request, limit: int) -> List[int]:
        """Up to ``min(draft_len, limit)`` guesses for the tokens after the
        pending one (``engine.py:1241``): the prefix tree's continuation
        of the history first (read-only, so drafting never perturbs
        eviction), then n-gram lookup over the history itself.  A wrong
        guess costs its verify row, never correctness."""
        k = min(self.draft_len, limit)
        if k <= 0:
            return []
        hist = np.concatenate([r.prompt.astype(np.int32),
                               np.asarray(r.out_tokens, np.int32)])
        out: List[int] = []
        if self.prefix is not None:
            out = [int(t) for t in self.prefix.suggest(hist, k)]
        while len(out) < k:
            ext = _ngram_continuation(
                np.concatenate([hist, np.asarray(out, np.int32)]),
                k - len(out))
            if not ext:
                break
            out.extend(ext)
        return out[:k]

    def _speculative_block(self, active, decoding, pos, tok) -> None:
        """One draft-then-verify dispatch across all slots
        (``engine.py:1268``): stack ``[pending, d1..dk]`` per slot into a
        ``[slots, W]`` window, score it with one ``verify_step``, accept
        the longest prefix of drafts equal to the model's own greedy
        argmax, and roll each slot's extent back over the rejected tail.
        Slots without drafts, idle slots and slots parked mid-prefill ride
        along on padding."""
        runnable = [s for s in range(self.slots)
                    if active[s] is not None and decoding[s]]
        drafts: Dict[int, List[int]] = {}
        caps: Dict[int, int] = {}
        need = 1
        for s in runnable:
            r = active[s]
            # At most ``cap`` tokens this dispatch: the remaining budget,
            # clamped to max_len.
            caps[s] = min(r.max_new_tokens - len(r.out_tokens),
                          self.max_len - int(pos[s]))
            drafts[s] = self._draft(r, caps[s] - 1)
            need = max(need, len(drafts[s]) + 1)
        w = next(x for x in self._w_ladder if x >= need)
        cow_src, cow_dst = self._provision(runnable, active, decoding, pos,
                                           tok, lambda s: w)
        runnable = [s for s in runnable
                    if active[s] is not None and decoding[s]]
        if not runnable:
            return
        t0 = self.clock()
        self._copy_on_write(cow_src, cow_dst)
        toks = np.zeros((self.slots, w), np.int32)
        dpos = np.full(self.slots, self.kv.extent, np.int32)
        dlen = np.zeros(self.slots, np.int32)
        for s in runnable:
            toks[s, 0] = tok[s, 0]
            d = drafts[s]
            toks[s, 1:1 + len(d)] = d
            dpos[s] = pos[s]
            dlen[s] = pos[s]
        dev = self.device
        greedy, _, _ = verify_step(
            self.params, self.cfg, torch.as_tensor(toks, device=dev),
            self.cache, torch.as_tensor(dpos, device=dev),
            torch.as_tensor(dlen, device=dev), page_table=self.kv.page_table,
            plan=self.plan)
        g = greedy.cpu().numpy()                     # [slots, W]: syncs
        dt = self.clock() - t0
        reg = self.registry
        reg["verify_dispatch_s"].observe(dt)
        if self.obs.enabled:
            self.obs.complete(DISPATCH_VERIFY, t0, dt, track=TRACK_ENGINE,
                              window=w, slots=len(runnable))
            for s in runnable:
                self.obs.complete("verify", t0, dt, track=slot_track(s),
                                  rid=active[s].rid, window=w,
                                  drafts=len(drafts[s]))
        useful = 0
        filled = 0
        for s in runnable:
            r = active[s]
            d = drafts[s]
            cap = caps[s]
            # Draft i is accepted while it equals the previous row's
            # greedy token: while the window tracks plain greedy decode.
            a = 0
            while (a < w - 1 and a + 1 < cap
                   and int(toks[s, a + 1]) == int(g[s, a])):
                a += 1
            delivered = a + 1
            r.out_tokens.extend(int(g[s, i]) for i in range(delivered))
            if r.first_token_at <= 0.0:
                self._stamp_first_token(r, s)       # bootstrap admission
            reg["generated"].inc(delivered)
            reg["spec_tokens"].inc(delivered)
            reg["draft_tokens"].inc(len(d))
            reg["accepted_tokens"].inc(min(a, len(d)))
            useful = max(useful, delivered)
            filled += delivered
            pos[s] = int(pos[s]) + delivered
            tok[s, 0] = int(g[s, a])
            # Pages wholly past the new write head held only rejected
            # rows: return them (exclusive by construction; checked).
            dropped = self.kv.rollback_extent(s, int(pos[s]))
            if dropped:
                reg["rollbacks"].inc()
                reg["rollback_pages"].inc(dropped)
            if self._debug_check_pages:
                self.kv.assert_page_accounting()
            if (len(r.out_tokens) >= r.max_new_tokens
                    or pos[s] >= self.max_len):
                self._retire(s, r, active, decoding, pos, tok)
        reg["dispatches"].inc()
        reg["verify_dispatches"].inc()
        reg["ticks"].inc(useful)
        reg["scan_ticks"].inc(w)
        reg["pages_in_use"].set(self.kv.pages_in_use)
        # Accepted tokens per verify row: a rejected row is wasted
        # capacity, as a wasted decode tick is.
        self.decode_eff = (0.5 * self.decode_eff
                           + 0.5 * filled / (w * len(runnable)))
