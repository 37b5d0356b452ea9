"""Prefix cache: radix-tree page sharing over the paged KV pools.

Port of ``repro.serving.prefix_cache`` against the port's allocator
(``kv_cache.PagedKVCache``).  A token-keyed radix tree over whole KV pages
(node key: one page of token ids; payload: the physical page holding that
chunk's K/V) lets a newly admitted request claim every matching prefix
page, by bumping its refcount and writing the shared id into its table
row, and prefill only from the first non-cached page on.  Sharing is exact:
a K/V row at position ``p`` is a function of tokens ``0..p`` and the
position alone, and a claimed page sits at the same logical positions in
the claiming slot.

Two matching granularities (DESIGN.md §10):

* **chunk-aligned** (default, bit-exact): prefill restarts on the
  engine's chunk grid and only pages below it are claimed, so every page
  in the tree was computed by the one chunk schedule and a hot request's
  outputs equal its cold run's;
* **bootstrap** (``bootstrap=True``, page-granular): claims every matching
  page, plus the partial tail page; a prompt whose cached coverage reaches
  ``plen - 1`` skips prefill and feeds its last token through decode,
  whose first append copy-on-writes the shared last page.

Custody and eviction: a slot's full prompt pages enter the tree when its
prefill completes (``mark_tree``); on slot exit they stay cached at
refcount 0, and when the free list runs dry the allocator calls
``evict_lru_leaf``, which reclaims the least recently stamped unreferenced
leaf through a stamp-keyed heap, or prunes the LRU unreferenced subtree
when no such leaf exists (``extend_claim`` can leave unreferenced
ancestors above referenced descendants).

The reference's telemetry instants are not ported; the counters the engine
reports (evictions) are plain attributes here.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..kernels.common import cdiv
from ..obs import (NULL_RECORDER, PREFIX_CLAIM, PREFIX_EVICT, PREFIX_INSERT,
                   TRACK_PREFIX)
from .kv_cache import NULL_PAGE, PagedKVCache


class _Node:
    """One radix-tree node: a page-aligned token chunk -> physical page."""

    __slots__ = ("key", "page", "children", "parent", "stamp", "dead")

    def __init__(self, key: Optional[Tuple[int, ...]], page: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.stamp = 0
        self.dead = False


@dataclass
class PrefixHit:
    """Outcome of one admission walk (already applied to the allocator).

    ``prefill_start``: the page-aligned offset chunked prefill resumes at;
    ``hit_pages``: pages claimed; ``cow``: the logical page whose first
    divergent write must swap in a private copy (the physical source is
    read from the table row at swap time); ``full``: a bootstrap full hit
    (skip prefill, first token through decode)."""

    prefill_start: int
    hit_pages: int
    prompt_pages: int
    cow: Optional[int] = None
    full: bool = False


class PrefixCache:
    """Radix tree over whole KV pages + LRU eviction + claim bookkeeping.

    Owns the token->page index and the nodes each slot holds; the
    refcount and free-list state lives in the ``PagedKVCache`` it wraps
    (the tree registers itself as the allocator's ``evictor``)."""

    def __init__(self, kv: PagedKVCache, *, chunk: Optional[int] = None,
                 bootstrap: bool = False, obs=NULL_RECORDER):
        if chunk is None:
            chunk = kv.page_size
        if chunk % kv.page_size != 0:
            raise ValueError(
                f"chunk {chunk} is not a multiple of page_size "
                f"{kv.page_size}")
        self.kv = kv
        # Telemetry recorder: claim/insert/evict instants on "prefix".
        self.obs = obs
        self.chunk = chunk
        self.bootstrap = bootstrap
        self.root = _Node(None, NULL_PAGE, None)
        # Nodes each slot holds, in the order it took them (root first):
        # release re-stamps them in that order, so eviction order never
        # depends on hashing (the reference keeps a set here).
        self._held: List[Dict[_Node, None]] = [{} for _ in range(kv.slots)]
        # Eviction index: a stamp-keyed min-heap with lazy invalidation
        # (every _stamp pushes; pops skip dead or stale entries), plus a
        # page -> node map so a refcount drop outside the release path
        # (COW) can refresh the node's heap entry.
        self._lru: List[Tuple[int, int, _Node]] = []
        self._by_page: Dict[int, _Node] = {}
        self._tick = 0
        self.nodes = 0
        self.evictions = 0
        kv.evictor = self.evict_lru_leaf

    # ------------------------------------------------------------- walk
    def _key(self, prompt: np.ndarray, i: int) -> Tuple[int, ...]:
        ps = self.kv.page_size
        return tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])

    def _walk(self, prompt: np.ndarray) -> List[_Node]:
        """The chain of nodes matching the prompt's full page chunks."""
        node, out = self.root, []
        for i in range(int(prompt.shape[0]) // self.kv.page_size):
            child = node.children.get(self._key(prompt, i))
            if child is None:
                break
            out.append(child)
            node = child
        return out

    def lookup_pages(self, prompt: np.ndarray) -> int:
        """Pages a claim would reuse (the ``admission="prefix"`` score); no
        refcount moves."""
        return len(self._walk(prompt))

    # ---------------------------------------------------------- drafting
    def suggest(self, tokens: np.ndarray, k: int) -> List[int]:
        """Up to ``k`` draft tokens a cached run continued with after
        ``tokens``.  Read-only: no refcount moves and no node is
        re-stamped, so drafting never perturbs eviction order.  Matches
        the history's full page chunks, then its partial remainder
        against a child key's prefix, then descends, preferring the most
        recently stamped child at each fork.  [] when the history diverges
        from everything cached."""
        if k <= 0:
            return []
        ps = self.kv.page_size
        n = int(tokens.shape[0])
        node = self.root
        for i in range(n // ps):
            child = node.children.get(self._key(tokens, i))
            if child is None or child.dead:
                return []
            node = child
        out: List[int] = []
        r = n % ps
        if r:
            tail = tuple(int(t) for t in tokens[n - r:])
            nxt = None
            for key, child in node.children.items():
                if child.dead or key[:r] != tail:
                    continue
                if nxt is None or child.stamp > nxt.stamp:
                    nxt = child
            if nxt is None:
                return []
            out.extend(nxt.key[r:])
            node = nxt
        while len(out) < k and node.children:
            nxt = max((c for c in node.children.values() if not c.dead),
                      key=lambda c: c.stamp, default=None)
            if nxt is None:
                break
            out.extend(nxt.key)
            node = nxt
        return out[:k]

    # ------------------------------------------------------------ claim
    def claim(self, slot: int, prompt: np.ndarray) -> PrefixHit:
        """Admission walk: claim matching pages into the slot's table row
        (``adopt_shared``) and decide where prefill resumes."""
        ps = self.kv.page_size
        plen = int(prompt.shape[0])
        full, r = plen // ps, plen % ps
        matched = self._walk(prompt)
        m = len(matched)
        cow: Optional[int] = None
        full_hit = False

        if self.bootstrap:
            claim_nodes = list(matched)
            covered = m * ps
            if m == full and r > 0:
                # A cached run that extends past this prompt holds its
                # tail rows: claim that child too when its first r tokens
                # match.
                tail = tuple(int(t) for t in prompt[full * ps:plen])
                parent = matched[-1] if matched else self.root
                for key, child in parent.children.items():
                    if key[:r] == tail:
                        claim_nodes.append(child)
                        covered = plen
                        break
            full_hit = bool(claim_nodes) and covered >= plen - 1
            prefill_start = plen if full_hit else m * ps
            if full_hit:
                # Does decode's first append (position plen - 1) land
                # inside a claimed page?
                j = (plen - 1) // ps
                if j < len(claim_nodes):
                    cow = j
        else:
            # Bit-exact: restart on the chunk grid; claim only below it.
            cs = (min(m * ps, plen - 1) // self.chunk) * self.chunk
            claim_nodes = matched[: cs // ps]
            prefill_start = cs

        for node in claim_nodes:
            self.kv.adopt_shared(slot, node.page)
            self._stamp(node)
            self._held[slot][node] = None
        if self.obs.enabled:
            self.obs.instant(PREFIX_CLAIM, track=TRACK_PREFIX, slot=slot,
                             hit_pages=len(claim_nodes),
                             prefill_start=prefill_start, full=full_hit)
        return PrefixHit(prefill_start=prefill_start,
                         hit_pages=len(claim_nodes),
                         prompt_pages=cdiv(plen, ps), cow=cow,
                         full=full_hit)

    def extend_claim(self, slot: int, prompt: np.ndarray,
                     off: int) -> Tuple[int, int]:
        """Mid-prefill catch-up walk: pages covering chunks at or after
        ``off`` may have appeared since admission (a same-wave request
        computing the shared prefix inserts as it completes).  Claims them
        and jumps the offset past them (chunk-aligned, capped at
        ``plen - 1`` so the final chunk still runs for logits).  Returns
        ``(new_off, pages_claimed)``."""
        ps = self.kv.page_size
        plen = int(prompt.shape[0])
        if self.kv.slot_pages(slot).size * ps != off:
            return off, 0            # mid-page or COW state: leave it
        matched = self._walk(prompt)
        cs = (min(len(matched) * ps, plen - 1) // self.chunk) * self.chunk
        if cs <= off:
            return off, 0
        claimed = 0
        for j in range(off // ps, cs // ps):
            node = matched[j]
            self.kv.adopt_shared(slot, node.page)
            self._stamp(node)
            self._held[slot][node] = None
            claimed += 1
        return cs, claimed

    # ----------------------------------------------------------- insert
    def insert(self, slot: int, prompt: np.ndarray) -> int:
        """Index the slot's full prompt pages once its prefill completes.
        Chunks already in the tree are re-stamped; a chunk that raced a
        concurrent cold admission keeps the first page inserted (this
        slot's duplicate stays exclusive).  Returns the nodes created."""
        ps = self.kv.page_size
        full = int(prompt.shape[0]) // ps
        row = self.kv.slot_pages(slot)
        node, created = self.root, 0
        for i in range(full):
            key = self._key(prompt, i)
            child = node.children.get(key)
            if child is None:
                page = int(row[i])
                child = _Node(key, page, node)
                node.children[key] = child
                self.kv.mark_tree(page)
                self._by_page[page] = child
                self.nodes += 1
                created += 1
            self._stamp(child)
            if child.page == row[i]:
                self._held[slot][child] = None
            node = child
        if self.obs.enabled:
            self.obs.instant(PREFIX_INSERT, track=TRACK_PREFIX, slot=slot,
                             created=created, pages=full)
        return created

    # ---------------------------------------------------------- custody
    def release_slot(self, slot: int) -> None:
        """Slot exit: re-stamp the nodes the slot held (most recently used
        at exit; the fresh heap entries make their now unreferenced pages
        reachable by eviction) and forget them.  The refcount drops happen
        in ``PagedKVCache.release``."""
        for node in self._held[slot]:
            self._stamp(node)
        self._held[slot] = {}

    def page_released(self, page: int) -> None:
        """A reference dropped outside the release path (the COW swap):
        refresh the node's heap entry."""
        node = self._by_page.get(page)
        if node is not None and not node.dead:
            self._stamp(node)

    def evict_lru_leaf(self) -> bool:
        """Reclaim the least recently stamped unreferenced page: pop the
        heap until a live unreferenced leaf surfaces and evict it; when no
        unreferenced leaf exists, prune the LRU unreferenced interior
        node's subtree.  False only when no tree page is unreferenced."""
        repush: List[Tuple[int, int, _Node]] = []
        best_interior: Optional[_Node] = None
        victim: Optional[_Node] = None
        while self._lru:
            entry = heapq.heappop(self._lru)
            stamp, _, node = entry
            if node.dead or stamp != node.stamp:
                continue                         # stale entry
            if self.kv.page_refs(node.page) != 0:
                continue                         # re-pushed on release
            repush.append(entry)
            if node.children:
                if best_interior is None:
                    best_interior = node
                continue
            victim = node
            break
        for entry in repush:
            heapq.heappush(self._lru, entry)
        if victim is None:
            victim = best_interior
        if victim is None:
            return False
        return self._prune(victim) > 0

    def _prune(self, node: _Node) -> int:
        """Detach ``node``'s subtree: unreferenced pages are reclaimed,
        referenced ones disowned (still valid for their slots).  Returns
        the pages freed."""
        del node.parent.children[node.key]
        freed = 0
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.dead = True
            self._by_page.pop(n.page, None)
            for held in self._held:
                held.pop(n, None)
            if self.kv.page_refs(n.page) == 0:
                self.kv.evict_page(n.page)
                freed += 1
            else:
                self.kv.disown(n.page)
            self.nodes -= 1
        self.evictions += freed
        if self.obs.enabled:
            self.obs.instant(PREFIX_EVICT, track=TRACK_PREFIX,
                             freed=freed, nodes=self.nodes)
        return freed

    def _stamp(self, node: _Node) -> None:
        self._tick += 1
        node.stamp = self._tick
        heapq.heappush(self._lru, (node.stamp, id(node), node))
