"""Host-side KV page accounting for the paged decode path (a copy of
``paddle_tpu/serving/paging.py``; the module is pure numpy).

vLLM-style PagedAttention bookkeeping (Kwon et al., SOSP 2023): the
device holds one flat page pool per layer (``GPTModel.init_paged_cache``
— ``[P+1, H, page, hd]`` with the last page as a write-drop page), and
*everything else lives here on the host*: per-slot page tables, the
slot→absolute-position map, per-page refcounts, the free list, and the
shared-prefix registry.  The device never sees an allocation decision —
it only receives fully-resolved int32 index tensors per call, so every
decode step has the same shapes.

Copy-on-write: ``share()`` maps a slot's leading page-table entries onto
an existing prefix's pages (refcount bump, no data movement).  A page
with refcount > 1 is read-only for its holders; before a slot's first
write into one, ``prepare_write()`` allocates a fresh page and reports a
``(src, dst)`` copy pair the engine dispatches through
``GPTModel.copy_pages`` — siblings still referencing ``src`` are never
perturbed.  Because prefixes rarely end on a page boundary, the registry
shares only ``min(prefix_len, len-1)`` tokens rounded *into* the
boundary page, and the admission path CoWs that partial boundary page
immediately: each admitted sibling gets a private copy to append into
while the full pages stay shared.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PagePool"]


class PagePool:
    """Refcounted free-list allocator over ``num_pages`` physical pages.

    Slot state (page table rows, position map) is owned here too so that
    admission / eviction / CoW are single-call table edits.  ``-1`` in a
    table row = unmapped; ``-1`` in ``pos_map`` = no valid KV at that
    cache slot (also how rejected speculative drafts are invalidated —
    the stale KV is simply never gathered and gets overwritten later).
    """

    def __init__(self, num_slots: int, num_pages: int, page_size: int,
                 max_len: int):
        if max_len % page_size:
            raise ValueError(
                f"kv_page_size={page_size} must divide max_len={max_len}")
        self.num_slots = int(num_slots)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_len = int(max_len)
        self.pages_per_slot = max_len // page_size
        if num_pages < self.pages_per_slot:
            raise ValueError(
                f"page pool too small: {num_pages} pages < "
                f"{self.pages_per_slot} needed for one max-length slot")
        self.refcount = np.zeros(self.num_pages, np.int32)
        self.free: List[int] = list(range(self.num_pages))
        # host-owned per-call device inputs
        self.table = -np.ones((num_slots, self.pages_per_slot), np.int32)
        self.pos_map = -np.ones((num_slots, max_len), np.int32)
        # prefix registry: key -> (page list, token array).  The tokens
        # are kept so reuse VERIFIES the match — a prefix_key whose
        # prompt has diverged silently falls back to a cold admission
        # instead of attending to someone else's KV.
        self._prefixes: Dict[str, Tuple[List[int], np.ndarray]] = {}
        self.cow_copies = 0
        self.prefix_hits = 0  # admissions that mapped shared prefix pages
        self.adoptions = 0    # slots mapped via KV hand-off (adopt())

    # -- allocation ---------------------------------------------------------
    def alloc(self) -> Optional[int]:
        """Pop one free page (refcount 1) or None when exhausted."""
        if not self.free:
            return None
        p = self.free.pop()
        self.refcount[p] = 1
        return p

    def decref(self, p: int):
        if p < 0:
            return
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self.free.append(p)
        elif self.refcount[p] < 0:  # pragma: no cover - invariant guard
            raise AssertionError(f"page {p} refcount went negative")

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def shared_pages(self) -> int:
        """Pages referenced by more than one holder."""
        return int((self.refcount > 1).sum())

    # -- slot lifecycle -----------------------------------------------------
    def shared_len(self, prompt: np.ndarray,
                   prefix_key: Optional[str]) -> int:
        """Leading tokens of ``prompt`` already resident under
        ``prefix_key``: ``min(registered, len(prompt) - 1)`` — always at
        least one fresh token so prefill has a next-token logit to emit —
        and 0 unless the registered tokens actually match."""
        if prefix_key is None or prefix_key not in self._prefixes:
            return 0
        _, toks = self._prefixes[prefix_key]
        n = min(len(toks), len(prompt) - 1)
        if n <= 0 or not np.array_equal(np.asarray(prompt[:n], np.int32),
                                        toks[:n]):
            return 0
        return n

    def pages_needed(self, prompt: np.ndarray,
                     prefix_key: Optional[str] = None) -> int:
        """Fresh pages admitting ``prompt`` will pop off the free list
        (full shared-prefix pages come free; a partial boundary page
        still needs a CoW target page)."""
        total = -(-len(prompt) // self.page_size)
        full = self.shared_len(prompt, prefix_key) // self.page_size
        return max(total - full, 0)

    def admit(self, slot: int, prompt: np.ndarray,
              prefix_key: Optional[str] = None):
        """Map ``slot`` for ``prompt`` and mark its positions resident.
        Returns ``(copy_pairs, shared)``: ``copy_pairs`` is a list of
        ``(src, dst)`` page copies the engine must dispatch *before* the
        prefill write (the CoW'd partial boundary page of a shared
        prefix), and ``shared`` is how many leading tokens are already
        resident (prefill skips recomputing them).  Raises
        ``MemoryError`` if the free list cannot cover it — callers
        pre-check with :meth:`pages_needed` / :attr:`free_pages` and
        defer or preempt instead.
        """
        assert (self.table[slot] < 0).all(), f"slot {slot} already mapped"
        length = len(prompt)
        copy_pairs: List[Tuple[int, int]] = []
        shared = self.shared_len(prompt, prefix_key)
        g0 = 0
        if shared:
            self.prefix_hits += 1
            pages, _ = self._prefixes[prefix_key]
            full = shared // self.page_size
            part = shared % self.page_size
            for g in range(full):
                self.table[slot, g] = pages[g]
                self.refcount[pages[g]] += 1
            g0 = full
            if part:
                # partial boundary page: private copy to append into
                dst = self.alloc()
                if dst is None:
                    self._rollback(slot)
                    raise MemoryError("page pool exhausted (CoW boundary)")
                copy_pairs.append((pages[full], dst))
                self.cow_copies += 1
                self.table[slot, g0] = dst
                g0 += 1
        for g in range(g0, -(-length // self.page_size)):
            p = self.alloc()
            if p is None:
                self._rollback(slot)
                raise MemoryError("page pool exhausted (admission)")
            self.table[slot, g] = p
        self.pos_map[slot, :length] = np.arange(length)
        return copy_pairs, shared

    def adopt(self, slot: int, length: int) -> List[int]:
        """Map ``slot`` for an externally-prefilled sequence of ``length``
        tokens — the import half of the prefill→decode KV hand-off.  The
        page *payload* arrives separately through
        ``GPTModel.scatter_pages``; this is only the host accounting:
        fresh private pages (hand-offs never share — the donor replica's
        prefix registry does not travel), positions ``0..length-1``
        marked resident.  Raises ``MemoryError`` on exhaustion with the
        slot rolled back, same contract as :meth:`admit`."""
        assert (self.table[slot] < 0).all(), f"slot {slot} already mapped"
        pages: List[int] = []
        for g in range(-(-int(length) // self.page_size)):
            p = self.alloc()
            if p is None:
                self._rollback(slot)
                raise MemoryError("page pool exhausted (adoption)")
            self.table[slot, g] = p
            pages.append(p)
        self.pos_map[slot, :length] = np.arange(length)
        self.adoptions += 1
        return pages

    def _rollback(self, slot: int):
        for g in range(self.pages_per_slot):
            p = self.table[slot, g]
            if p >= 0:
                self.decref(int(p))
                self.table[slot, g] = -1
        self.pos_map[slot] = -1

    def release(self, slot: int):
        """Eviction: return the slot's pages to the free list (modulo
        refcounts held by siblings / the prefix registry) and clear its
        position map.  Pure table edit — no device call."""
        self._rollback(slot)

    def ensure_writable(self, slot: int, pos: int):
        """Guarantee ``slot`` may write KV at absolute position ``pos``:
        allocate the page if unmapped, CoW it if shared.  Returns a
        ``(src, dst)`` copy pair to dispatch first, or ``None``.  Raises
        ``MemoryError`` on exhaustion (caller preempts)."""
        g = (pos % self.max_len) // self.page_size
        p = int(self.table[slot, g])
        if p < 0:
            np_ = self.alloc()
            if np_ is None:
                raise MemoryError("page pool exhausted (decode)")
            self.table[slot, g] = np_
            return None
        if self.refcount[p] > 1:
            dst = self.alloc()
            if dst is None:
                raise MemoryError("page pool exhausted (CoW)")
            self.refcount[p] -= 1  # we drop our ref on the shared page
            self.table[slot, g] = dst
            self.cow_copies += 1
            return (p, dst)
        return None

    # -- shared prefixes ----------------------------------------------------
    def register_prefix(self, key: str, slot: int, tokens: np.ndarray):
        """Publish ``slot``'s first ``len(tokens)`` prompt tokens as
        shareable prefix ``key``.  The registry itself holds a refcount
        on every page so the prefix survives the donor slot's eviction;
        the donor's own next write into the (now refcount-2) boundary
        page CoWs automatically via :meth:`ensure_writable`.  The
        published length is capped at ``max_len - page_size`` so a
        full-length prefix never pins all of a future sibling's pages."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        tokens = tokens[: self.max_len - self.page_size]
        if len(tokens) <= 0 or key in self._prefixes:
            return
        n = -(-len(tokens) // self.page_size)
        pages = [int(self.table[slot, g]) for g in range(n)]
        if any(p < 0 for p in pages):
            return
        for p in pages:
            self.refcount[p] += 1
        self._prefixes[key] = (pages, tokens)

    def has_prefix(self, key: str) -> bool:
        return key in self._prefixes

    def drop_prefix(self, key: str):
        if key in self._prefixes:
            pages, _ = self._prefixes.pop(key)
            for p in pages:
                self.decref(p)

    def drop_all_prefixes(self):
        """Reclaim every registered prefix's pages — the engine's
        emergency lever when admission is starved for pages with no live
        slots left to preempt (prefixes re-register off future donors)."""
        for key in list(self._prefixes):
            self.drop_prefix(key)

    # -- diagnostics --------------------------------------------------------
    def leaked_pages(self) -> int:
        """Pages with a live refcount that no slot table and no
        registered prefix references — the invariant a page leak breaks
        (analysis rule S604 fires on this going non-zero while
        admissions are being deferred)."""
        referenced = set(int(p) for p in self.table.ravel() if p >= 0)
        for pages, _ in self._prefixes.values():
            referenced.update(pages)
        held = set(int(p) for p in np.nonzero(self.refcount > 0)[0])
        return len(held - referenced)

    def stats(self) -> Dict[str, int]:
        return {
            "kv_pages_free": self.free_pages,
            "kv_pages_shared": self.shared_pages,
            "cow_copies": self.cow_copies,
            "prefix_hits": self.prefix_hits,
            "kv_adoptions": self.adoptions,
            "kv_pages_leaked": self.leaked_pages(),
        }
