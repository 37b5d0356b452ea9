"""Paged KV cache: page pools, page-table primitives, refcounted allocator.

Port of ``repro.serving.kv_cache`` on the main path:

* K/V storage is a pool of fixed-size pages per layer, page-major:
  ``[L, P, page_size, Hkv, hd]``.  Physical page 0 is the NULL page:
  unallocated table entries point at it, and writes at or past a slot's
  table extent land in it, so every indexed read and write is in bounds.
* A page table ``[slots, max_pages]`` int32 maps a slot's logical page j to
  a physical page; it lives on the host and is uploaded per dispatch.
* The host-side allocator hands out pages from a free list with refcounts
  and returns them when a request retires.

Where the reference's primitives return updated arrays from a donated jit,
the port's update the pool tensors in place (``index_put_``), which is what
donation bought there.  Prefix sharing, copy-on-write, rollback,
quantized pools and mesh placement come with later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.common import DeviceLike, cdiv, resolve_device
from ..models.params import CacheDef, attn_cache_defs, cache_leaf_kind

NULL_PAGE = 0


def to_page_major(seq: torch.Tensor, layout: str) -> torch.Tensor:
    """K/V with a batch axis -> [..., S, H, hd] order."""
    return seq.transpose(-3, -2) if layout == "bhsd" else seq


def from_page_major(seq: torch.Tensor, layout: str) -> torch.Tensor:
    return seq.transpose(-3, -2) if layout == "bhsd" else seq


def paged_append(pool: torch.Tensor, page_table: torch.Tensor,
                 pos: torch.Tensor, new: torch.Tensor, *,
                 layout: str) -> torch.Tensor:
    """Scatter one decode token per slot into its page, in place.

    pool [P, page_size, H, hd]; page_table [B, max_pages] int32; pos [B]
    absolute write positions; new [B, 1, H, hd] ("bshd").  A position at or
    past the table extent (an idle or parked slot) routes to the NULL page
    instead of rewriting a live row.  Returns ``pool``."""
    page_size = pool.shape[1]
    b = page_table.shape[0]
    tok = to_page_major(new, layout)[:, 0]                 # [B, H, hd]
    extent = page_table.shape[1] * page_size
    pos = pos.long()
    in_range = (pos >= 0) & (pos < extent)
    posc = pos.clamp(0, extent - 1)
    rows = torch.arange(b, device=pool.device)
    phys = torch.where(in_range, page_table[rows, posc // page_size].long(),
                       NULL_PAGE)
    pool[phys, posc % page_size] = tok.to(pool.dtype)
    return pool


def live_page_table(page_table: torch.Tensor, lengths,
                    page_size: int) -> torch.Tensor:
    """Re-route table entries wholly past the live prefix to the NULL page.

    page_table [max_pages] (one slot) or [B, max_pages]; lengths the
    matching int or [B] valid-token counts."""
    lengths = torch.as_tensor(lengths, device=page_table.device)
    live = (lengths + page_size - 1) // page_size
    idx = torch.arange(page_table.shape[-1], device=page_table.device)
    if page_table.dim() == 2:
        mask = idx[None] < live.reshape(-1, 1)
    else:
        mask = idx < live
    return torch.where(mask, page_table, torch.full_like(page_table,
                                                         NULL_PAGE))


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor, *,
                 layout: str) -> torch.Tensor:
    """Per-slot contiguous K/V from the pool: [P, ps, H, hd] ->
    [B, max_pages * ps, H, hd] ("bshd")."""
    pages = pool[page_table.long()]               # [B, max_pages, ps, H, hd]
    b, n, ps, h, hd = pages.shape
    return from_page_major(pages.reshape(b, n * ps, h, hd), layout)


def place_chunk_pages(pool: torch.Tensor, seq: torch.Tensor,
                      chunk_pages: torch.Tensor, *,
                      layout: str) -> torch.Tensor:
    """Write one page-aligned prefill chunk's K/V into its physical pages,
    in place.  seq [1, C, H, hd] ("bshd"); chunk_pages [C // page_size]
    (NULL past the slot's capacity: pad tokens land in the NULL page)."""
    page_size = pool.shape[1]
    x = to_page_major(seq, layout)[0]                      # [C, H, hd]
    c, h, hd = x.shape
    chunks = x.reshape(c // page_size, page_size, h, hd)
    pool[chunk_pages.long()] = chunks.to(pool.dtype)
    return pool


def place_prefill(cache: Dict[str, torch.Tensor],
                  fresh: Dict[str, torch.Tensor], pages: torch.Tensor, *,
                  layout: str) -> Dict[str, torch.Tensor]:
    """Write one request's whole-prompt prefill cache into its pages, in
    place (full-precision branch of ``kv_cache.py:399``).

    fresh {"k", "v"} [L, 1, S, H, hd] ("bshd"); pages [n] int32 the slot's
    physical pages from ``ensure(slot, S)``, n = cdiv(S, page_size).  The
    last page is zero-padded past S.  Returns ``cache``."""
    for name, small in fresh.items():
        if cache_leaf_kind(name) != "kv":
            raise NotImplementedError(f"placing cache leaf {name!r} is not "
                                      "ported yet")
        pool = cache[name]
        page_size = pool.shape[2]
        seq = to_page_major(small, layout)[:, 0]           # [L, S, H, hd]
        layers, s, h, hd = seq.shape
        n = pages.shape[0]
        pad = n * page_size - s
        if pad:
            seq = torch.nn.functional.pad(seq, (0, 0, 0, 0, 0, pad))
        pool[:, pages.long()] = seq.reshape(layers, n, page_size, h,
                                            hd).to(pool.dtype)
    return cache


def stage_chunk(prompt: np.ndarray, off: int, chunk: int, row: np.ndarray,
                page_size: int):
    """Host-side staging of one prefill chunk (``kv_cache.py:493``):
    returns (tokens [chunk] zero-padded past the prompt, chunk_pages
    [chunk // page_size] with NULL past the table extent, last_idx — the
    within-chunk index of the prompt's final token, clamped)."""
    n_cp = chunk // page_size
    j0 = off // page_size
    cpages = np.full(n_cp, NULL_PAGE, np.int32)
    n = max(0, min(n_cp, int(row.shape[0]) - j0))
    cpages[:n] = row[j0:j0 + n]
    toks = np.zeros(chunk, np.int32)
    seg = prompt[off:off + chunk]
    toks[:len(seg)] = seg
    last = min(int(prompt.shape[0]) - 1 - off, chunk - 1)
    return toks, cpages, last


def paged_cache_defs(cfg: ModelConfig, slots: int, max_len: int,
                     page_size: int) -> Dict[str, CacheDef]:
    """K/V page pools ``[L, 1 + slots * cdiv(max_len, ps), ps, Hkv, hd]``
    (+1: the NULL page)."""
    if cfg.kv_quant is not None:
        raise NotImplementedError("quantized KV pools are not ported yet")
    num_pages = 1 + slots * cdiv(max_len, page_size)
    out = {}
    for name, cd in attn_cache_defs(cfg, slots, max_len).items():
        layers, _, _, hkv, hd = cd.shape
        out[name] = CacheDef((layers, num_pages, page_size, hkv, hd),
                             cd.dtype)
    return out


class PagedKVCache:
    """Device page pools + host page table + refcounted allocator.

    A page is free (on ``_free``, refs 0) or referenced (refs > 0 — the
    number of slots whose table rows carry it).  ``ensure`` allocates
    exclusively; ``release`` drops a slot's references exactly once.
    ``assert_page_accounting`` checks that partition.
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, max_len: int,
                 page_size: int = 16, device: DeviceLike = None):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.slots = slots
        self.max_len = max_len
        self.page_size = min(page_size, max_len)
        self.pages_per_slot = cdiv(max_len, self.page_size)
        self.num_pages = 1 + slots * self.pages_per_slot
        self._defs = paged_cache_defs(cfg, slots, max_len, self.page_size)
        # Bytes of ONE physical page summed over every pool leaf (all
        # layers): the unit of the bytes-in-use accounting.
        self.page_bytes = 0
        for name, cd in self._defs.items():
            cache_leaf_kind(name)            # raises on an unknown leaf
            per_page = int(np.prod(cd.shape)) // cd.shape[1]
            self.page_bytes += per_page * torch.empty(
                (), dtype=cd.dtype).element_size()
        self._table = np.zeros((slots, self.pages_per_slot), np.int32)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        self._refs = np.zeros(self.num_pages, np.int64)
        self._in_use = 0
        self.peak_pages = 0

    def init_cache(self) -> Dict[str, torch.Tensor]:
        """Fresh zeroed pools on the device.  The engine owns them and the
        model updates them in place; this object tracks which page is
        whose."""
        return {name: torch.zeros(cd.shape, dtype=cd.dtype,
                                  device=self.device)
                for name, cd in self._defs.items()}

    # ------------------------------------------------------------ state
    @property
    def page_table(self) -> torch.Tensor:
        return torch.as_tensor(self._table, device=self.device)

    @property
    def pages_in_use(self) -> int:
        return self._in_use

    @property
    def peak_bytes_in_use(self) -> int:
        return self.peak_pages * self.page_bytes

    @property
    def extent(self) -> int:
        """Positions addressable through a table row (>= max_len)."""
        return self.pages_per_slot * self.page_size

    def table_row(self, slot: int) -> np.ndarray:
        return self._table[slot].copy()

    def slot_pages(self, slot: int) -> np.ndarray:
        return np.asarray(self._owned[slot], np.int32)

    def _ref(self, page: int) -> None:
        if self._refs[page] == 0:
            self._in_use += 1
        self._refs[page] += 1

    def _deref(self, page: int) -> None:
        if self._refs[page] <= 0:
            raise RuntimeError(f"double release of page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._in_use -= 1
            self.free_page(page)

    # ------------------------------------------------------- allocation
    def alloc_page(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"KV page pool exhausted ({self.num_pages - 1} pages)")
        return self._free.pop()

    def free_page(self, page: int) -> None:
        if self._refs[page] != 0 or page == NULL_PAGE:
            raise RuntimeError(f"page {page} cannot be freed "
                               f"(refs {int(self._refs[page])})")
        self._free.append(page)

    def ensure(self, slot: int, length: int) -> np.ndarray:
        """Allocate pages so ``slot`` can hold ``length`` tokens; returns
        its physical pages.  ``length`` past ``max_len`` raises."""
        if length > self.max_len:
            raise ValueError(
                f"cannot ensure {length} tokens: slot capacity is "
                f"max_len={self.max_len}")
        need = cdiv(max(length, 1), self.page_size)
        owned = self._owned[slot]
        while len(owned) < need:
            page = self.alloc_page()
            self._ref(page)
            self._table[slot, len(owned)] = page
            owned.append(page)
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return self.slot_pages(slot)

    def release(self, slot: int) -> None:
        """Drop a slot's page references exactly once and point its table
        row back at the NULL page.  A second release is a no-op."""
        for page in reversed(self._owned[slot]):
            self._deref(page)
        self._owned[slot] = []
        self._table[slot, :] = NULL_PAGE

    # ------------------------------------------------------- invariants
    def assert_page_accounting(
            self, cache: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Every physical page except NULL is free xor referenced; the
        free list holds no duplicates; refcounts equal table occupancy;
        table rows hold the owned pages then NULL.  With ``cache``, its
        pools must match the definitions."""
        free = list(self._free)
        free_set = set(free)
        if len(free) != len(free_set):
            raise AssertionError("free list holds duplicates")
        if NULL_PAGE in free_set:
            raise AssertionError("NULL page on the free list")
        counts = np.zeros(self.num_pages, np.int64)
        for owned in self._owned:
            for page in owned:
                counts[page] += 1
        if not np.array_equal(counts, self._refs):
            raise AssertionError("refcounts disagree with slot ownership")
        referenced = {p for p in range(1, self.num_pages) if self._refs[p]}
        if self._in_use != len(referenced):
            raise AssertionError("in-use counter drifted")
        if free_set & referenced:
            raise AssertionError("referenced page on the free list")
        if free_set | referenced != set(range(1, self.num_pages)):
            raise AssertionError("page leaked (neither free nor referenced)")
        for slot, owned in enumerate(self._owned):
            if (list(self._table[slot, :len(owned)]) != owned
                    or np.any(self._table[slot, len(owned):] != NULL_PAGE)):
                raise AssertionError(f"table row {slot} out of step with "
                                     "its pages")
        if cache is not None:
            for name, cd in self._defs.items():
                leaf = cache[name]
                if tuple(leaf.shape) != cd.shape or leaf.dtype != cd.dtype:
                    raise AssertionError(
                        f"pool {name} {tuple(leaf.shape)}/{leaf.dtype} vs "
                        f"definition {cd.shape}/{cd.dtype}")
