"""Paged KV cache: page pools, page-table primitives, refcounted allocator.

Port of ``repro.serving.kv_cache`` on the main path:

* K/V storage is a pool of fixed-size pages per layer, page-major and
  layout-canonical: ``[L, P, page_size, Hkv, hd]`` whatever the config's
  ``kv_cache_layout``.  The primitives take K/V in the model's layout ("bshd"
  ``[B, S, H, hd]`` or "bhsd" ``[B, H, S, hd]``, ``layout=``) and convert at
  the edges (``to_page_major`` / ``from_page_major``), so the paged kernels
  see the same pools under either layout.  Physical page 0 is the NULL page:
  unallocated table entries point at it, and writes at or past a slot's table
  extent land in it, so every indexed read and write is in bounds.
* A page table ``[slots, max_pages]`` int32 maps a slot's logical page j to
  a physical page; it lives on the host and is uploaded per dispatch.
* The host-side allocator hands out pages from a free list with refcounts.
  Several slots may reference one page (prefix sharing), the prefix tree
  may keep a page cached after every slot let go of it, a shared page is
  copied before a slot writes into it (copy-on-write), and a speculative
  draft's freshly opened pages roll back.

Quantized pools (DESIGN.md §14): under a KV quant mode each K/V pool
stores int8 or fp8-e4m3 codes, ``value ≈ code * scale``, with one float32
scale per (physical page, KV head) in a sibling ``<name>_scale`` pool
``[L, P, Hkv]`` indexed by the same page ids.  Whole pages (prefill chunks,
whole-prompt placement) set their scale from their own amax; appends fold
it in monotonically (``max(old, amax / qmax)``) and re-encode the page's
earlier rows when it grows.  A page that ``ensure`` hands out starts at
scale 0, as every page of a fresh pool does: the reference keeps whatever
scale the page's previous owner left (``kv_cache.py:239``), so there a
request's tokens depend on the traffic served before it.

A Mamba2 stack's recurrent state (``ssm``, ``conv``) and an RWKV6
stack's (``wkv``, ``tm_shift``, ``cm_shift``) are not paged: they sit
slot-contiguously beside the pools, one row per slot (``[L, slots,
...]``), outside the page accounting; whole-prompt placement replaces
the slot's row (``kv_cache.py:426-428``).  An RWKV6 stack has no
attention and so no K/V pools at all: the page table and the allocator
still run (a slot's pages bound its length), and hold nothing.

Where the reference's primitives return updated arrays from a donated jit,
the port's update the pool tensors in place (``index_put_``), which is what
donation bought there.  Mesh placement comes with a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.common import DeviceLike, cdiv, resolve_device
from ..kernels.ref import code_view
from ..models.params import (CacheDef, attn_cache_defs, cache_leaf_kind,
                             state_cache_defs)
from ..obs import (NULL_RECORDER, PAGE_ALLOC, PAGE_COW, PAGE_EVICT,
                   PAGE_FREE, PAGE_ROLLBACK, TRACK_KV)

NULL_PAGE = 0


def to_page_major(seq: torch.Tensor, layout: str) -> torch.Tensor:
    """K/V with a batch axis -> [..., S, H, hd] order."""
    return seq.transpose(-3, -2) if layout == "bhsd" else seq


def from_page_major(seq: torch.Tensor, layout: str) -> torch.Tensor:
    return seq.transpose(-3, -2) if layout == "bhsd" else seq


# --------------------------------------------------------------------- #
# KV quantization (``kv_cache.py:106-160``)
# --------------------------------------------------------------------- #

def kv_quant_dtype(kind: Optional[str]) -> Optional[torch.dtype]:
    """Pool storage dtype for a ``ModelConfig.kv_quant`` kind."""
    if kind is None:
        return None
    if kind == "int8":
        return torch.int8
    if kind == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown kv quant kind {kind!r}")


def kv_quant_qmax(dtype: torch.dtype) -> float:
    """Largest representable code magnitude (amax maps onto it)."""
    return 127.0 if dtype == torch.int8 else 448.0   # e4m3fn finite max


def quantize_kv(x: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Encode values as codes at ``scale`` (broadcastable): ``x / scale``
    (zero where the scale is zero), clipped to the code range, then rounded
    half to even (int8) or cast (fp8, which rounds)."""
    qmax = kv_quant_qmax(dtype)
    v = torch.where(scale > 0, x.float() / torch.clamp(scale, min=1e-30),
                    0.0)
    v = torch.clamp(v, -qmax, qmax)
    if dtype == torch.int8:
        return torch.round(v).to(torch.int8)
    return v.to(dtype)


def _requant_codes(codes: torch.Tensor, old_scale: torch.Tensor,
                   new_scale: torch.Tensor) -> torch.Tensor:
    """Re-encode a page's codes after its scale grew: ``code * old / new``.
    At an unchanged scale the ratio is exactly 1.0, an identity."""
    ratio = torch.where(new_scale > 0,
                        old_scale / torch.clamp(new_scale, min=1e-30), 0.0)
    v = codes.float() * ratio
    if codes.dtype == torch.int8:
        return torch.round(v).to(torch.int8)
    return v.to(codes.dtype)


def _take(pool: torch.Tensor, idx) -> torch.Tensor:
    """``pool[idx]``, through the bytes for fp8 codes."""
    return code_view(pool)[idx].view(pool.dtype)


def _put(pool: torch.Tensor, idx, vals: torch.Tensor) -> None:
    """``pool[idx] = vals`` in place, through the bytes for fp8 codes."""
    code_view(pool)[idx] = code_view(vals.to(pool.dtype))


def paged_append(pool: torch.Tensor, page_table: torch.Tensor,
                 pos: torch.Tensor, new: torch.Tensor, *,
                 layout: str) -> torch.Tensor:
    """Scatter one decode token per slot into its page, in place.

    pool [P, page_size, H, hd]; page_table [B, max_pages] int32; pos [B]
    absolute write positions; new [B, 1, H, hd] ("bshd") or [B, H, 1, hd]
    ("bhsd").  A position at or
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

    new [B, W, H, hd] ("bshd", or [B, H, W, hd] "bhsd") lands at positions
    ``pos[b] .. pos[b] + W - 1``; each row resolves its own physical page, and
    a row at or past the table extent (or negative) routes to the NULL page,
    as in ``paged_append`` (``kv_cache.py:266``).  Rows past the accepted
    prefix are stale after acceptance: the engine rolls the extent back and
    later writes overwrite them.  Returns ``pool``."""
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


def _append_row_q(pool: torch.Tensor, scale: torch.Tensor,
                  page_table: torch.Tensor, pos: torch.Tensor,
                  tok: torch.Tensor) -> None:
    """Quantize-on-write of one page-major token row per slot, in place
    (``kv_cache.py:216``): pool [P, ps, H, hd] codes, scale [P, H] float32,
    tok [B, H, hd].  The page's scale becomes ``max(old, amax(tok) /
    qmax)``; the page's codes are re-encoded at it (an identity when it did
    not grow) and the row written.  Out-of-range positions route to the
    NULL page, as in ``paged_append``."""
    page_size = pool.shape[1]
    b = page_table.shape[0]
    extent = page_table.shape[1] * page_size
    pos = pos.long()
    in_range = (pos >= 0) & (pos < extent)
    posc = pos.clamp(0, extent - 1)
    rows = torch.arange(b, device=pool.device)
    phys = torch.where(in_range, page_table[rows, posc // page_size].long(),
                       NULL_PAGE)
    qmax = kv_quant_qmax(pool.dtype)
    amax = tok.float().abs().amax(dim=-1)                   # [B, H]
    old = scale[phys]
    new = torch.maximum(old, amax / qmax)
    page = _requant_codes(_take(pool, phys), old[:, None, :, None],
                          new[:, None, :, None])
    row = quantize_kv(tok, new[..., None], pool.dtype)
    _put(pool, phys, page)
    _put(pool, (phys, posc % page_size), row)
    scale[phys] = new


def paged_append_q(pool: torch.Tensor, scale: torch.Tensor,
                   page_table: torch.Tensor, pos: torch.Tensor,
                   new: torch.Tensor, *, layout: str) -> None:
    """Quantized twin of ``paged_append`` (``kv_cache.py:249``): one decode
    token per slot written as codes, its magnitude folded into the page's
    scale; pool and scale updated in place."""
    _append_row_q(pool, scale, page_table, pos,
                  to_page_major(new, layout)[:, 0])


def paged_append_window_q(pool: torch.Tensor, scale: torch.Tensor,
                          page_table: torch.Tensor, pos: torch.Tensor,
                          new: torch.Tensor, *, layout: str) -> None:
    """Quantized twin of ``paged_append_window`` (``kv_cache.py:305``): the
    W rows are appended one after another through ``_append_row_q``, so a
    window that grows a page's scale re-encodes earlier rows exactly as
    single-token decode would."""
    win = to_page_major(new, layout)                       # [B, W, H, hd]
    for i in range(win.shape[1]):
        _append_row_q(pool, scale, page_table, pos + i, win[:, i])


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
    [B, max_pages * ps, H, hd] ("bshd") or [B, H, max_pages * ps, hd]
    ("bhsd")."""
    pages = _take(pool, page_table.long())        # [B, max_pages, ps, H, hd]
    b, n, ps, h, hd = pages.shape
    return from_page_major(pages.reshape(b, n * ps, h, hd), layout)


def gather_pages_dequant(pool: torch.Tensor, scale: torch.Tensor,
                         page_table: torch.Tensor, *,
                         layout: str) -> torch.Tensor:
    """Quantized twin of ``gather_pages`` (``kv_cache.py:351``): dense
    float32 K/V, each gathered page's codes times its (page, head) scale."""
    pages = _take(pool, page_table.long()).float()   # [B, n, ps, H, hd]
    s = scale[page_table.long()]                     # [B, n, H]
    pages = pages * s[:, :, None, :, None]
    b, n, ps, h, hd = pages.shape
    return from_page_major(pages.reshape(b, n * ps, h, hd), layout)


def _encode_pages(chunks: torch.Tensor, dtype: torch.dtype,
                  page_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes and per-(page, head) scales of whole pages ``[..., n, ps, H,
    hd]`` (page axis ``page_axis``): each page's scale is its own amax over
    positions and head dim, over qmax."""
    amax = chunks.float().abs().amax(dim=(page_axis + 1, page_axis + 3))
    new = amax / kv_quant_qmax(dtype)                # [..., n, H]
    return quantize_kv(chunks, new.unsqueeze(-2).unsqueeze(-1), dtype), new


def place_chunk_pages_q(pool: torch.Tensor, scale: torch.Tensor,
                        seq: torch.Tensor, chunk_pages: torch.Tensor, *,
                        layout: str) -> None:
    """Quantized twin of ``place_chunk_pages`` (``kv_cache.py:325``): whole
    pages are encoded at scales from their own content, so the scale is
    set, not folded; pool and scale updated in place."""
    page_size = pool.shape[1]
    x = to_page_major(seq, layout)[0]                      # [C, H, hd]
    c, h, hd = x.shape
    codes, new = _encode_pages(x.reshape(c // page_size, page_size, h, hd),
                               pool.dtype, 0)
    _put(pool, chunk_pages.long(), codes)
    scale[chunk_pages.long()] = new


def place_chunk_pages(pool: torch.Tensor, seq: torch.Tensor,
                      chunk_pages: torch.Tensor, *,
                      layout: str) -> torch.Tensor:
    """Write one page-aligned prefill chunk's K/V into its physical pages,
    in place.  seq [1, C, H, hd] ("bshd") or [1, H, C, hd] ("bhsd");
    chunk_pages [C // page_size]
    (NULL past the slot's capacity: pad tokens land in the NULL page)."""
    page_size = pool.shape[1]
    x = to_page_major(seq, layout)[0]                      # [C, H, hd]
    c, h, hd = x.shape
    chunks = x.reshape(c // page_size, page_size, h, hd)
    pool[chunk_pages.long()] = chunks.to(pool.dtype)
    return pool


def place_prefill(cache: Dict[str, torch.Tensor],
                  fresh: Dict[str, torch.Tensor], pages: torch.Tensor, *,
                  layout: str, slot: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """Write one request's whole-prompt prefill cache into its pages and
    its slot's state rows, in place (``kv_cache.py:399``).

    fresh {"k", "v"} [L_attn, 1, S, H, hd] ("bshd"; [L_attn, 1, H, S, hd]
    under "bhsd") and, for a Mamba2
    or RWKV6 stack, the state leaves [L, 1, ...] (an RWKV6 stack's alone);
    pages [n] int32 the slot's physical pages from ``ensure(slot, S)``, n
    = cdiv(S, page_size).  The last page is zero-padded past S.  Quantized pools (a ``<name>_scale``
    sibling in ``cache``) get each page's codes at its own scale, and the
    scale rows are set.  A state leaf replaces row ``slot`` (required
    when ``fresh`` holds one).  Returns ``cache``."""
    for name, small in fresh.items():
        pool = cache[name]
        if cache_leaf_kind(name) == "state":
            if slot is None:
                raise ValueError(f"placing state leaf {name!r} needs the "
                                 "slot")
            pool[:, slot] = small[:, 0].to(pool.dtype)
            continue
        page_size = pool.shape[2]
        seq = to_page_major(small, layout)[:, 0]           # [L, S, H, hd]
        layers, s, h, hd = seq.shape
        n = pages.shape[0]
        pad = n * page_size - s
        if pad:
            seq = torch.nn.functional.pad(seq, (0, 0, 0, 0, 0, pad))
        chunks = seq.reshape(layers, n, page_size, h, hd)
        sname = name + "_scale"
        if sname in cache:
            codes, new = _encode_pages(chunks, pool.dtype, 1)
            _put(pool, (slice(None), pages.long()), codes)
            cache[sname][:, pages.long()] = new
        else:
            pool[:, pages.long()] = chunks.to(pool.dtype)
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
    """K/V page pools ``[L_attn, 1 + slots * cdiv(max_len, ps), ps, Hkv,
    hd]`` (+1: the NULL page), page-major under either layout.  Under a KV
    quant mode the pools hold int8 / fp8 codes and each gains a
    ``<name>_scale`` pool ``[L_attn, P, Hkv]`` float32
    (``kv_cache.py:523-554``).  A Mamba2 or RWKV6 stack's state leaves follow,
    slot-contiguous (``state_cache_defs``); an RWKV6 stack has no pools."""
    num_pages = 1 + slots * cdiv(max_len, page_size)
    qdtype = kv_quant_dtype(cfg.kv_quant)
    out = {}
    hkv, hd = cfg.num_kv_heads, cfg.head_dim_
    for name, cd in attn_cache_defs(cfg, slots, max_len).items():
        layers = cd.shape[0]
        out[name] = CacheDef((layers, num_pages, page_size, hkv, hd),
                             qdtype or cd.dtype)
        if qdtype is not None:
            out[name + "_scale"] = CacheDef((layers, num_pages, hkv),
                                            torch.float32)
    out.update(state_cache_defs(cfg, slots))
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
                 page_size: int = 16, device: DeviceLike = None,
                 obs=NULL_RECORDER):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.cfg = cfg
        # Telemetry recorder (``obs/events.py``): page lifecycle instants on
        # the "kv" track, each site behind ``obs.enabled`` so the disabled
        # path builds no argument dict.
        self.obs = obs
        self.device = resolve_device(device)
        self.slots = slots
        self.max_len = max_len
        self.page_size = min(page_size, max_len)
        self.pages_per_slot = cdiv(max_len, self.page_size)
        self.num_pages = 1 + slots * self.pages_per_slot
        self._defs = paged_cache_defs(cfg, slots, max_len, self.page_size)
        # Bytes of ONE physical page summed over every pool leaf (all
        # layers, scale pools included), each at its own dtype's size: the
        # unit of the bytes-in-use accounting (``kv_cache.py:642-660``).
        # State leaves have no pages and stay out of it.
        self.page_bytes = 0
        self._kv_elems_per_page = 0
        for name, cd in self._defs.items():
            kind = cache_leaf_kind(name)     # raises on an unknown leaf
            if kind == "state":
                continue
            per_page = int(np.prod(cd.shape)) // cd.shape[1]
            self.page_bytes += per_page * torch.empty(
                (), dtype=cd.dtype).element_size()
            if kind == "kv":
                self._kv_elems_per_page += per_page
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
        self._scales: List[torch.Tensor] = []   # init_cache's scale pools

    def init_cache(self) -> Dict[str, torch.Tensor]:
        """Fresh zeroed pools on the device (fp8 codes zeroed through their
        bytes: 0x00 is +0.0).  The engine owns them and the model updates
        them in place; this object tracks which page is whose, and zeroes
        the scale rows of each page ``ensure`` hands out."""
        def zeros(cd: CacheDef) -> torch.Tensor:
            raw = torch.uint8 if cd.dtype == torch.float8_e4m3fn else cd.dtype
            return torch.zeros(cd.shape, dtype=raw,
                               device=self.device).view(cd.dtype)

        cache = {name: zeros(cd) for name, cd in self._defs.items()}
        self._scales = [t for name, t in cache.items()
                        if name.endswith("_scale")]
        return cache

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
    def kv_itemsize_effective(self) -> float:
        """Stored bytes per K/V element with the scale pools amortized in
        (bf16 2.0; int8 with per-page, per-head float32 scales a little
        above 1.0; ``kv_cache.py:745``).  Without K/V pools, the compute
        dtype's size, as the reference's contiguous engine reports
        (``engine.py:632-634``); the reference's paged cache divides by
        zero there."""
        if not self._kv_elems_per_page:
            return 2.0 if self.cfg.dtype == "bfloat16" else 4.0
        return self.page_bytes / self._kv_elems_per_page

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
        page = self._free.pop()
        if self.obs.enabled:
            self.obs.instant(PAGE_ALLOC, track=TRACK_KV, page=page,
                             free=len(self._free))
        return page

    def free_page(self, page: int) -> None:
        if self._refs[page] != 0 or page == NULL_PAGE:
            raise RuntimeError(f"page {page} cannot be freed "
                               f"(refs {int(self._refs[page])})")
        self._free.append(page)
        if self.obs.enabled:
            self.obs.instant(PAGE_FREE, track=TRACK_KV, page=page,
                             free=len(self._free))

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
        new = []
        while len(owned) < need:
            page = self.alloc_page()
            self._ref(page)
            self._table[slot, len(owned)] = page
            owned.append(page)
            new.append(page)
        if new and self._scales:
            # A reused page must not keep its previous owner's scale; its
            # stale codes re-encode to 0 at the first append.
            idx = torch.as_tensor(new, device=self.device)
            for scale in self._scales:
                scale[:, idx] = 0.0
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
        if self.obs.enabled:
            self.obs.instant(PAGE_COW, track=TRACK_KV, slot=slot,
                             src=src, dst=dst, logical=logical)
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
        if dropped and self.obs.enabled:
            self.obs.instant(PAGE_ROLLBACK, track=TRACK_KV, slot=slot,
                             pages=dropped, length=length)
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
        if self.obs.enabled:
            self.obs.instant(PAGE_EVICT, track=TRACK_KV, page=page)
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
        # Value / scale pool lockstep (``kv_cache.py:962-982``).
        qdtype = kv_quant_dtype(self.cfg.kv_quant)
        for name, cd in self._defs.items():
            if cache_leaf_kind(name) != "kv":
                continue
            scd = self._defs.get(name + "_scale")
            if qdtype is None:
                if scd is not None:
                    raise AssertionError(f"unexpected scale pool {name}_scale "
                                         "without kv quant")
                continue
            if scd is None:
                raise AssertionError(f"missing scale pool {name}_scale")
            if (scd.shape != (cd.shape[0], cd.shape[1], cd.shape[3])
                    or scd.dtype != torch.float32 or cd.dtype != qdtype):
                raise AssertionError(
                    f"{name}_scale {scd.shape}/{scd.dtype} out of lockstep "
                    f"with {name} {cd.shape}/{cd.dtype}")
        if cache is not None:
            if set(cache) != set(self._defs):
                raise AssertionError(f"cache leaves {sorted(cache)} vs "
                                     f"definitions {sorted(self._defs)}")
            for name, cd in self._defs.items():
                leaf = cache[name]
                if tuple(leaf.shape) != cd.shape or leaf.dtype != cd.dtype:
                    raise AssertionError(
                        f"pool {name} {tuple(leaf.shape)}/{leaf.dtype} vs "
                        f"definition {cd.shape}/{cd.dtype}")
