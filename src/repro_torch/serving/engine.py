"""Serving engine: continuous batching over paged KV, with chunked or
whole-prompt prefill.

Port of ``repro.serving.engine`` on the paged paths.  Requests are
admitted to cache slots one by one (FIFO) the moment a slot frees up.
With ``chunked`` (the default), prompts are prefilled in fixed-size,
page-aligned chunks (the plan's attention ``block_q`` rounded to whole
pages) and a token-budget scheduler hands each pass prefill chunks, a
decode block, or both.  With ``chunked=False`` each admitted prompt is
prefilled whole, at its own length, and its fresh K/V placed into the
slot's pages before the slot joins decode.  A decode block
runs ``decode_block`` steps for all slots with the sampled tokens kept on
the device and read back once per block (the reference runs the block as
one ``lax.scan``).  Idle slots and slots parked mid-prefill ride along in
decode with their write position at the table extent — their writes go to
the NULL page — and length 0; their outputs are discarded.

Left for later slices: telemetry, trace probes, autotuning, plan
verification, the prefix cache, speculative decoding, quantized pools,
meshes, the contiguous cache and the ``bhsd`` layout.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.common import DeviceLike, resolve_device
from ..models.model import (decode_step, prefill, prefill_chunk,
                            resolve_plan, supports_chunked_prefill)
from .kv_cache import PagedKVCache, place_prefill, stage_chunk

Tree = Any

METRIC_NAMES = ("generated", "ticks", "scan_ticks", "dispatches", "prefills",
                "prefill_chunks", "rejected", "kv_bytes_peak",
                "pages_in_use")


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
                 device: DeviceLike = None):
        if not supports_chunked_prefill(cfg):
            raise NotImplementedError(
                f"config {cfg.name!r} carries recurrent state or mrope "
                "positions, whose layers are not ported yet")
        # None: chunked whenever the config supports it (``engine.py:367``),
        # which every config the port serves does.
        self.chunked = True if chunked is None else bool(chunked)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
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
        self.kv = PagedKVCache(cfg, slots=batch_slots, max_len=max_len,
                               page_size=page_size, device=self.device)
        self.cache = self.kv.init_cache()
        ps = self.kv.page_size
        want = (self.plan.prefill_chunk_size(ps) if self.plan is not None
                else 4 * ps)
        self.chunk = max(ps, min(want, self.kv.extent))
        self.metrics: Dict[str, int] = {name: 0 for name in METRIC_NAMES}

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
                self._decode_block(active, decoding, pos, tok)
                progressed = True
            if not progressed:
                break
        self.metrics["kv_bytes_peak"] = max(self.metrics["kv_bytes_peak"],
                                            self.kv.peak_bytes_in_use)
        self.metrics["pages_in_use"] = self.kv.pages_in_use
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

    def _validate(self, r: Request) -> Optional[str]:
        """A bad prompt fails at admission, never mid-dispatch."""
        plen = int(r.prompt.shape[0]) if r.prompt.ndim >= 1 else 0
        if plen == 0:
            return "empty prompt"
        if plen > self.max_len:
            return f"prompt length {plen} exceeds max_len {self.max_len}"
        return None

    def _admit_pending(self, pending, active, decoding, pos, tok) -> None:
        """Fill every free slot from the queue in arrival order; invalid
        prompts are failed and skipped.  Chunked admission only assigns
        the slot (prefill is scheduled chunk by chunk); whole-prompt
        admission prefills the prompt here."""
        for s in range(self.slots):
            while active[s] is None and pending:
                r = pending.popleft()
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
        flips the slot to decoding."""
        c = self.chunk
        plen = int(r.prompt.shape[0])
        off = r.prefill_pos
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
        self.kv.release(slot)

    def _decode_block(self, active, decoding, pos, tok) -> None:
        """``decode_block`` steps across all slots, each at its own
        position; tokens stay on the device until the block ends."""
        runnable = [s for s in range(self.slots)
                    if active[s] is not None and decoding[s]]
        block = self.decode_block
        for s in list(runnable):
            r = active[s]
            # Allocate only what the request's remaining budget can read
            # back: later ticks write past the allocated pages, which
            # routes them to the NULL page, and their tokens are dropped.
            h = min(block, r.max_new_tokens - len(r.out_tokens))
            try:
                self.kv.ensure(s, min(int(pos[s]) + h, self.max_len))
            except RuntimeError as e:
                r.failed = True
                r.error = str(e)
                self.metrics["rejected"] += 1
                self._retire(s, r, active, decoding, pos, tok)
        runnable = [s for s in runnable
                    if active[s] is not None and decoding[s]]
        if not runnable:
            return
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
