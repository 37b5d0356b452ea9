"""Paged KV cache: page pools, page-table primitives, refcounted allocator.

Port of ``repro.serving.kv_cache`` on the main path:

* K/V storage is a pool of fixed-size pages per layer, page-major:
  ``[L, P, page_size, Hkv, hd]``.  Physical page 0 is the NULL page:
  unallocated table entries point at it, and writes at or past a slot's
  table extent land in it, so every indexed read and write is in bounds.
* A page table ``[slots, max_pages]`` int32 maps a slot's logical page j to
  a physical page; it lives on the host and is uploaded per dispatch.
* The host-side allocator hands out pages from a free list with refcounts.
  Several slots may reference one page (prefix sharing), the prefix tree
  may keep a page cached after every slot let go of it, a shared page is
  copied before a slot writes into it (copy-on-write), and a speculative
  draft's freshly opened pages roll back.

Where the reference's primitives return updated arrays from a donated jit,
the port's update the pool tensors in place (``index_put_``), which is what
donation bought there.  Quantized pools and mesh placement come with later
slices.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

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


def paged_append_window(pool: torch.Tensor, page_table: torch.Tensor,
                        pos: torch.Tensor, new: torch.Tensor, *,
                        layout: str) -> torch.Tensor:
    """Scatter a W-token verify window per slot into its pages, in place.

    new [B, W, H, hd] ("bshd") lands at positions ``pos[b] .. pos[b] + W -
    1``; each row resolves its own physical page, and a row at or past the
    table extent (or negative) routes to the NULL page, as in
    ``paged_append`` (``kv_cache.py:266``).  Rows past the accepted prefix
    are stale after acceptance: the engine rolls the extent back and later
    writes overwrite them.  Returns ``pool``."""
    page_size = pool.shape[1]
    b = page_table.shape[0]
    win = to_page_major(new, layout)                       # [B, W, H, hd]
    w = win.shape[1]
    extent = page_table.shape[1] * page_size
    p = pos.long()[:, None] + torch.arange(w, device=pool.device)[None]
    in_range = (p >= 0) & (p < extent)
    pc = p.clamp(0, extent - 1)
    rows = torch.arange(b, device=pool.device)[:, None]
    phys = torch.where(in_range, page_table[rows, pc // page_size].long(),
                       NULL_PAGE)
    pool[phys, pc % page_size] = win.to(pool.dtype)
    return pool


def cow_copy_pool(pool: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """Copy physical page(s) ``src`` onto ``dst`` inside a pool, in place:
    the copy-on-write primitive (``kv_cache.py:162``).

    pool [P, page_size, H, hd], or [L, P, page_size, H, hd] for every layer
    at once; src/dst [N] page ids.  A shared page is duplicated into a
    fresh one before the first divergent write, so the writer mutates its
    private copy and every other referent keeps the original.  Slots with
    nothing to copy pass NULL onto NULL, a no-op.  Returns ``pool``."""
    pool[..., dst.long(), :, :, :] = pool[..., src.long(), :, :, :]
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

    Page states (``kv_cache.py:567-589``):

    * **free**: on ``_free``, refs 0, not tree-owned;
    * **referenced**: refs = the number of slots whose table rows carry
      the page; ``ensure`` allocates exclusively (refs 1), ``adopt_shared``
      claims an existing page (refs + 1);
    * **cached**: refs 0 but owned by the prefix tree (``mark_tree``): the
      page keeps its K/V after every referencing slot exited and returns
      through ``evict_page``, which the ``evictor`` hook drives when the
      free list runs dry.

    ``release`` drops a slot's references exactly once; a page goes back
    to the free list only at refs 0 and not tree-owned.  A shared page
    counts once in ``pages_in_use``.  ``assert_page_accounting`` checks
    the partition.
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
        self._in_use = 0            # distinct pages with refs > 0
        self._tree: set = set()     # pages the prefix tree owns
        # Called when the free list runs dry: reclaims >= 1 cached page
        # (through ``evict_page``) and returns True, or returns False.
        self.evictor: Optional[Callable[[], bool]] = None
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
        """Distinct physical pages referenced by slots: a page shared by k
        slots counts once."""
        return self._in_use

    @property
    def pages_cached(self) -> int:
        """Tree-owned pages no slot references: K/V kept warm for future
        prefix hits, reclaimable by eviction."""
        return sum(1 for p in self._tree if self._refs[p] == 0)

    @property
    def bytes_cached(self) -> int:
        return self.pages_cached * self.page_bytes

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

    def page_refs(self, page: int) -> int:
        return int(self._refs[page])

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
            if page not in self._tree:
                self.free_page(page)

    # ------------------------------------------------------- allocation
    def alloc_page(self) -> int:
        """Pop one free page, evicting cached prefix pages through the
        ``evictor`` hook when the free list is dry.  Raises when every
        page is referenced (a copy-on-write needs one transient extra
        page, so a fully referenced pool can legally fail here; the
        engine fails that one request)."""
        while not self._free:
            if self.evictor is None or not self.evictor():
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
        its physical pages.  Pages already in the row (allocated earlier or
        adopted from the prefix tree) are kept; only the tail is
        allocated.  ``length`` past ``max_len`` raises."""
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

    def adopt_shared(self, slot: int, page: int) -> int:
        """Claim an existing (tree-cached or other-slot) page as the slot's
        next logical page: bump its refcount and write its id into the
        table row.  Returns the logical index."""
        owned = self._owned[slot]
        logical = len(owned)
        self._ref(page)
        self._table[slot, logical] = page
        owned.append(page)
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return logical

    def cow_page(self, slot: int, logical: int) -> Tuple[int, int]:
        """Copy-on-write swap: replace the slot's shared logical page with
        a fresh exclusive one.  Returns ``(src, dst)`` for the page copy
        (``cow_copy_pool``); the table row already points at ``dst``.  The
        slot's reference moves: ``src`` drops one (staying cached when the
        tree owns it), ``dst`` starts at one."""
        src = self._owned[slot][logical]
        dst = self.alloc_page()
        self._ref(dst)
        self._deref(src)
        self._owned[slot][logical] = dst
        self._table[slot, logical] = dst
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return src, dst

    def rollback_extent(self, slot: int, length: int) -> int:
        """Truncate a slot's extent to ``length`` tokens after a rejected
        speculative draft, releasing the pages wholly past it exactly once;
        returns how many.  A partial last page is kept (its stale rows are
        masked by the slot's length and overwritten later).  Draft pages
        are opened fresh each dispatch, so every truncated page must be
        exclusive (refs 1) and not tree-owned: anything else raises before
        the allocator is touched."""
        keep = cdiv(max(length, 1), self.page_size)
        owned = self._owned[slot]
        for page in owned[keep:]:
            if self._refs[page] != 1 or page in self._tree:
                raise RuntimeError(
                    f"rollback of slot {slot} would release page {page} "
                    f"(refs {int(self._refs[page])}, tree "
                    f"{page in self._tree}): draft pages must be exclusive "
                    "and never tree-adopted")
        dropped = 0
        while len(owned) > keep:
            page = owned.pop()
            self._table[slot, len(owned)] = NULL_PAGE
            self._deref(page)
            dropped += 1
        return dropped

    # ------------------------------------------------- tree page custody
    def mark_tree(self, page: int) -> None:
        """Hand custody of a page to the prefix tree: at refcount 0 it
        stays cached (not freed) until ``evict_page`` reclaims it."""
        self._tree.add(page)

    def evict_page(self, page: int) -> None:
        """Tree eviction: reclaim a cached (refs 0, tree-owned) page."""
        if page not in self._tree or self._refs[page] != 0:
            raise RuntimeError(f"page {page} is not a cached page "
                               f"(refs {int(self._refs[page])})")
        self._tree.discard(page)
        self.free_page(page)

    def disown(self, page: int) -> None:
        """Revoke tree custody without freeing: a pruned subtree's
        still-referenced pages keep serving their slots and return to the
        free list when their last reference drops."""
        self._tree.discard(page)

    def release(self, slot: int) -> None:
        """Drop a slot's page references exactly once and point its table
        row back at the NULL page: exclusive pages return to the free list,
        shared pages lose one reference, tree-owned pages stay cached.  A
        second release is a no-op."""
        for page in reversed(self._owned[slot]):
            self._deref(page)
        self._owned[slot] = []
        self._table[slot, :] = NULL_PAGE

    # ------------------------------------------------------- invariants
    def assert_page_accounting(
            self, cache: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Every physical page except NULL is in exactly one state: free,
        referenced, or cached (tree-owned at refs 0); the free list holds
        no duplicates and nothing referenced or cached; refcounts equal
        table occupancy; table rows hold the owned pages then NULL.  With
        ``cache``, its pools must match the definitions."""
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
        cached = {p for p in self._tree if self._refs[p] == 0}
        if free_set & referenced:
            raise AssertionError("referenced page on the free list")
        if free_set & cached:
            raise AssertionError("cached page on the free list")
        if free_set | referenced | cached != set(range(1, self.num_pages)):
            raise AssertionError("page leaked (no state)")
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
