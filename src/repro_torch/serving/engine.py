"""Serving engine: continuous batching over paged KV, with chunked or
whole-prompt prefill, the prefix cache and self-speculative decoding.

Port of ``repro.serving.engine`` on the paged paths.  Requests are
admitted to cache slots one by one the moment a slot frees up, in the
order ``admission`` picks (FIFO, shortest prompt first, or longest cached
prefix first).  With ``chunked`` (the default), prompts are prefilled in
fixed-size, page-aligned chunks (the plan's attention ``block_q`` rounded
to whole pages) and a token-budget scheduler hands each pass prefill
chunks, a decode block, or both.  With ``chunked=False`` each admitted
prompt is prefilled whole, at its own length, and its fresh K/V placed
into the slot's pages before the slot joins decode.

Prefix cache (DESIGN.md §10), on by default whenever prefill is chunked:
admission walks a radix tree over whole KV pages (``prefix_cache.py``),
claims every cached page of the prompt's prefix into the slot's table row
and prefills only the rest; a slot's full prompt pages enter the tree when
its prefill completes and stay cached after it exits, until memory
pressure evicts them.  ``prefix_bootstrap`` also claims the partial tail
page and serves a fully cached prompt through decode alone, copying the
shared last page (copy-on-write) before the first append.

A decode block runs ``decode_block`` steps for all slots with the sampled
tokens kept on the device and read back once per block (the reference runs
the block as one ``lax.scan``).  With ``speculative`` the decode block is
replaced by draft-then-verify (DESIGN.md §11): each pass drafts up to
``draft_len`` tokens per slot on the host (the prefix tree's
continuations, then n-gram lookup over the slot's own history), scores
``[pending, drafts]`` with one ``verify_step`` dispatch, keeps the drafts
while they equal the model's own greedy argmax (so outputs equal the
plain engine's) and rolls the slot's page extent back over the rejected
tail.  Window widths snap to a ladder of at most three rungs.

Idle slots and slots parked mid-prefill ride along in decode and verify
with their write position at the table extent (their writes go to the
NULL page) and length 0; their outputs are discarded.

Quantized serving (DESIGN.md §14): ``quant=`` replaces the config's quant
mode for this engine.  KV modes store the page pools as int8 / fp8 codes
with per-(page, KV head) scales; weight modes run the kernel plan's w8
stages on int8 weights, quantized once when the engine is built.

Left for later slices: telemetry, trace probes, autotuning, plan
verification, ``adaptive_decode_block``, meshes, the contiguous cache and
the ``bhsd`` layout.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.common import DeviceLike, resolve_device
from ..kernels.ref import code_view
from ..models.model import (decode_step, prefill, prefill_chunk,
                            resolve_plan, supports_chunked_prefill,
                            supports_speculative, verify_step)
from ..models.params import quantize_weights
from .kv_cache import NULL_PAGE, PagedKVCache, place_prefill, stage_chunk
from .prefix_cache import PrefixCache

Tree = Any

# Counters (accumulate over the engine's life), as the reference registers
# them (``engine.py:590-612``).
COUNTER_NAMES = (
    "generated", "ticks", "scan_ticks", "dispatches", "prefills",
    "prefill_chunks", "rejected", "prefix_hit_pages", "prompt_pages",
    "cow_copies", "prefix_bootstraps", "prefix_evictions", "draft_tokens",
    "accepted_tokens", "spec_tokens", "verify_dispatches", "rollbacks",
    "rollback_pages")
# Gauges (point in time) and lifetime rates.
GAUGE_NAMES = ("kv_bytes_peak", "pages_in_use", "prefix_cached_pages",
               "kv_bytes_cached", "prefix_hit_rate", "accept_rate",
               "dispatches_per_token", "kv_itemsize_effective")
METRIC_NAMES = COUNTER_NAMES + GAUGE_NAMES
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
                 decode_block: int = 16, chunked: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_bootstrap: bool = False, admission: str = "fifo",
                 speculative: bool = False, draft_len: int = 4,
                 quant: Optional[str] = None, device: DeviceLike = None):
        # ``quant`` replaces the config's quant mode for this engine
        # (``engine.py:256-267``); the plan and the pool dtypes follow it.
        if quant is not None and quant != cfg.quant:
            cfg = replace(cfg, quant=quant)
        if not supports_chunked_prefill(cfg):
            raise NotImplementedError(
                f"config {cfg.name!r} carries recurrent state or mrope "
                "positions, whose layers are not ported yet")
        if admission not in ADMISSION:
            raise ValueError(f"unknown admission policy {admission!r} "
                             "(fifo | sjf | prefix)")
        self.admission = admission
        # None: chunked whenever the config supports it (``engine.py:367``),
        # which every config the port serves does.
        self.chunked = True if chunked is None else bool(chunked)
        self.device = resolve_device(device)
        self.cfg = cfg
        # The plan's w8 stages read int8 codes quantized here, once.
        self.params = quantize_weights(cfg, params)
        self.slots = batch_slots
        self.max_len = max_len
        self.decode_block = max(1, decode_block)
        self.clock = time.perf_counter
        # EMA of the per-dispatch useful-tick fraction: the prefill
        # budget's decode-pressure signal (1.0 = every tick useful).
        self.decode_eff = 1.0
        # One plan drives both stream granules: the KV page size and the
        # prefill chunk (a whole number of pages).  None when eager.
        self.plan = resolve_plan(cfg, batch_slots, kv_len=max_len)
        page_size = (self.plan.decode_page_size(16)
                     if self.plan is not None else 16)

        # Self-speculative decoding: the plan clamps the verify window to
        # its KV page granule (``engine.py:379-408``).
        self.draft_len = int(draft_len)
        if speculative:
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

        self.kv = PagedKVCache(cfg, slots=batch_slots, max_len=max_len,
                               page_size=page_size, device=self.device)
        self.cache = self.kv.init_cache()
        if self.chunked:
            ps = self.kv.page_size
            want = (self.plan.prefill_chunk_size(ps)
                    if self.plan is not None else 4 * ps)
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
                                      bootstrap=prefix_bootstrap)
        # Pending copy-on-write per slot: the logical page whose next
        # write must swap in a private copy.
        self._cow: List[Optional[int]] = [None] * batch_slots
        self.metrics: Dict[str, Any] = {name: 0 for name in METRIC_NAMES}
        self.metrics["quant"] = cfg.quant
        self.metrics["kv_itemsize_effective"] = self.kv.kv_itemsize_effective

    # -------------------------------------------------------------- API
    @torch.no_grad()
    def generate(self, prompts: List[np.ndarray],
                 max_new_tokens: int = 16) -> List[Request]:
        """Serve a list of prompts (any mix of lengths) to completion."""
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                        max_new_tokens=max_new_tokens,
                        submitted_at=self.clock())
                for i, p in enumerate(prompts)]
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
        m = self.metrics
        m["kv_bytes_peak"] = max(m["kv_bytes_peak"],
                                 self.kv.peak_bytes_in_use)
        m["pages_in_use"] = self.kv.pages_in_use
        if self.prefix is not None:
            # Lifetime rate: hit pages over every prompt page admitted.
            m["prefix_hit_rate"] = (m["prefix_hit_pages"]
                                    / max(m["prompt_pages"], 1))
            m["prefix_evictions"] = self.prefix.evictions
            m["prefix_cached_pages"] = self.kv.pages_cached
            m["kv_bytes_cached"] = self.kv.bytes_cached
        if self.speculative:
            m["accept_rate"] = (m["accepted_tokens"]
                                / max(m["draft_tokens"], 1))
            m["dispatches_per_token"] = (m["verify_dispatches"]
                                         / max(m["spec_tokens"], 1))
        return reqs

    # ------------------------------------------------------- scheduling
    def _prefill_budget(self, active, decoding) -> int:
        """Prefill tokens for one pass (``engine.py:799``): one chunk per
        slot waiting on prefill, plus the decode backlog's share that the
        ``decode_eff`` EMA says decode is not using."""
        waiting = sum(1 for s in range(self.slots)
                      if active[s] is not None and not decoding[s])
        if not waiting:
            return 0
        backlog = sum(1 for s in range(self.slots)
                      if active[s] is not None and decoding[s])
        slack = (1.0 - self.decode_eff) * backlog
        share = min(float(self.slots), waiting + slack)
        return int(self.chunk * max(1.0, share))

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
                    self.metrics["rejected"] += 1
                    continue
                r.admitted_at = self.clock()
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
        self.metrics["prefix_hit_pages"] += hit.hit_pages
        self.metrics["prompt_pages"] += hit.prompt_pages
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
        self.metrics["prefix_bootstraps"] += 1
        self.metrics["prefills"] += 1

    def _admit(self, slot: int, r: Request, pos, tok) -> None:
        """Whole-prompt prefill at the request's own length into the slot's
        pages (``engine.py:969``); emits the first token."""
        plen = int(r.prompt.shape[0])
        dev = self.device
        pages = torch.as_tensor(self.kv.ensure(slot, plen), device=dev)
        logits, fresh = prefill(self.params, self.cfg,
                                torch.as_tensor(r.prompt, device=dev)[None],
                                plan=self.plan)
        place_prefill(self.cache, fresh, pages,
                      layout=self.cfg.kv_cache_layout)
        t = int(logits[0, 0].argmax())              # reads back: syncs
        r.out_tokens.append(t)
        r.first_token_at = self.clock()
        r.prefill_pos = plen
        pos[slot] = plen
        tok[slot, 0] = t
        self.metrics["prefills"] += 1
        self.metrics["generated"] += 1

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
                self.metrics["prefix_hit_pages"] += caught
        try:
            self.kv.ensure(slot, min(off + c, self.max_len))
        except RuntimeError as e:
            r.failed = True
            r.error = str(e)
            self.metrics["rejected"] += 1
            self._retire(slot, r, active, decoding, pos, tok)
            return
        row = self.kv.table_row(slot)
        toks, cpages, last = stage_chunk(r.prompt, off, c, row,
                                         self.kv.page_size)
        dev = self.device
        next_tok, _, _ = prefill_chunk(
            self.params, self.cfg, torch.as_tensor(toks, device=dev)[None],
            self.cache, torch.as_tensor(row, device=dev),
            torch.as_tensor(cpages, device=dev), off, last, plan=self.plan)
        r.prefill_pos = min(off + c, plen)
        self.metrics["prefill_chunks"] += 1
        if r.prefill_pos < plen:
            return                                  # more chunks to go
        if self.prefix is not None:
            self.prefix.insert(slot, r.prompt)
        t = int(next_tok[0, 0])                     # reads back: syncs
        r.out_tokens.append(t)
        r.first_token_at = self.clock()
        pos[slot] = plen
        tok[slot, 0] = t
        decoding[slot] = True
        self.metrics["prefills"] += 1
        self.metrics["generated"] += 1
        if (len(r.out_tokens) >= r.max_new_tokens
                or pos[slot] >= self.max_len):
            self._retire(slot, r, active, decoding, pos, tok)

    def _retire(self, slot: int, r: Request, active, decoding, pos,
                tok) -> None:
        r.done = True
        r.finished_at = self.clock()
        active[slot] = None
        decoding[slot] = False
        pos[slot] = 0
        tok[slot, 0] = 0
        self._cow[slot] = None
        if self.prefix is not None:
            # Drop the tree's hold first (re-stamps the prefix as most
            # recently used); tree pages stay cached after the release.
            self.prefix.release_slot(slot)
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
                    self.metrics["cow_copies"] += 1
                    # The slot's reference moved off the shared src page.
                    self.prefix.page_released(int(cow_src[s]))
                self.kv.ensure(s, min(int(pos[s]) + width(s), self.max_len))
            except RuntimeError as e:
                r.failed = True
                r.error = str(e)
                self.metrics["rejected"] += 1
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
        for pool in self.cache.values():            # [L, P, ...]
            raw = code_view(pool)
            raw[:, dst] = raw[:, src]

    def _decode_block(self, active, decoding, pos, tok) -> None:
        """``decode_block`` steps across all slots, each at its own
        position; tokens stay on the device until the block ends."""
        runnable = [s for s in range(self.slots)
                    if active[s] is not None and decoding[s]]
        block = self.decode_block
        # Allocate only what each request's remaining budget can read back:
        # later ticks write past the allocated pages, which routes them to
        # the NULL page, and their tokens are dropped.
        cow_src, cow_dst = self._provision(
            runnable, active, decoding, pos, tok,
            lambda s: min(block, active[s].max_new_tokens
                          - len(active[s].out_tokens)))
        runnable = [s for s in runnable
                    if active[s] is not None and decoding[s]]
        if not runnable:
            return
        self._copy_on_write(cow_src, cow_dst)
        dpos = np.full(self.slots, self.kv.extent, np.int32)
        dlen = np.zeros(self.slots, np.int32)
        for s in runnable:
            dpos[s] = pos[s]
            dlen[s] = pos[s]
        dev = self.device
        tok_d = torch.as_tensor(tok, device=dev)
        pos_d = torch.as_tensor(dpos, device=dev)
        len_d = torch.as_tensor(dlen, device=dev)
        table = self.kv.page_table
        steps = []
        for _ in range(block):
            tok_d, _, _ = decode_step(self.params, self.cfg, tok_d,
                                      self.cache, pos_d, len_d,
                                      page_table=table, plan=self.plan)
            steps.append(tok_d[:, 0])
            pos_d = pos_d + 1
            len_d = len_d + 1
        toks_np = torch.stack(steps).cpu().numpy()   # [block, slots]: syncs
        useful = 0
        for s in runnable:
            r = active[s]
            h = min(block, r.max_new_tokens - len(r.out_tokens),
                    self.max_len - int(pos[s]))
            r.out_tokens.extend(int(t) for t in toks_np[:h, s])
            if r.out_tokens and r.first_token_at <= 0.0:
                r.first_token_at = self.clock()     # bootstrap admission
            useful = max(useful, h)
            self.metrics["generated"] += h
            pos[s] = min(int(pos[s]) + block, self.max_len)
            tok[s, 0] = toks_np[-1, s]
            if (len(r.out_tokens) >= r.max_new_tokens
                    or pos[s] >= self.max_len):
                self._retire(s, r, active, decoding, pos, tok)
        self.metrics["dispatches"] += 1
        self.metrics["ticks"] += useful
        self.metrics["scan_ticks"] += block
        self.metrics["pages_in_use"] = self.kv.pages_in_use
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
        useful = 0
        filled = 0
        m = self.metrics
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
                r.first_token_at = self.clock()     # bootstrap admission
            m["generated"] += delivered
            m["spec_tokens"] += delivered
            m["draft_tokens"] += len(d)
            m["accepted_tokens"] += min(a, len(d))
            useful = max(useful, delivered)
            filled += delivered
            pos[s] = int(pos[s]) + delivered
            tok[s, 0] = int(g[s, a])
            # Pages wholly past the new write head held only rejected
            # rows: return them (exclusive by construction; checked).
            dropped = self.kv.rollback_extent(s, int(pos[s]))
            if dropped:
                m["rollbacks"] += 1
                m["rollback_pages"] += dropped
            if self._debug_check_pages:
                self.kv.assert_page_accounting()
            if (len(r.out_tokens) >= r.max_new_tokens
                    or pos[s] >= self.max_len):
                self._retire(s, r, active, decoding, pos, tok)
        m["dispatches"] += 1
        m["verify_dispatches"] += 1
        m["ticks"] += useful
        m["scan_ticks"] += w
        m["pages_in_use"] = self.kv.pages_in_use
        # Accepted tokens per verify row: a rejected row is wasted
        # capacity, as a wasted decode tick is.
        self.decode_eff = (0.5 * self.decode_eff
                           + 0.5 * filled / (w * len(runnable)))
