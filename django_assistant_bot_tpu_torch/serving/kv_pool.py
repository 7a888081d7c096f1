"""Paged KV memory plane, host side (port of ``serving/kv_pool.py``).

Pure-Python page bookkeeping: the free list, refcounts and the
shareable-prefix registry.  The device half (the ``[L, P + 1, KH, page, D]``
pools, block-table reads, page-granular writes, ``copy_pages``) lives in
``models/llama.py``; the engine wires the two together.

Prefix sharing:

- After a request with a declared shared prefix (system prompt + packed RAG
  context) finishes its prefill, the engine *registers* the pages covering
  the prefix here.  The registry holds one refcount per page, so the pages
  outlive the owning request.
- A later request whose prompt starts with a registered prefix *shares* the
  fully covered pages read-only (one incref each, no copy, no model compute)
  and takes a **copy-on-write** clone of the boundary page the prefix only
  partly fills: its own suffix K/V lands there.  Positions below the prefix
  length in the clone hold the owner's prefix K/V (valid for every consumer:
  RoPE is absolute-position); positions at or above it are overwritten by
  the sharer's suffix prefill before they are ever unmasked.
- Entries LRU-evict past ``max_shared_bytes`` or ``max_shared_entries``, and
  :meth:`PageAllocator.alloc` evicts on demand when the free list alone
  cannot satisfy a request: cached prefixes are a scavengeable use of free
  pages, never a reason to shed traffic.

The JAX allocator's host KV tier (spill and restore of evicted prefixes,
ROADMAP Queue 1 item 12) is not ported; without it an evicted entry is
dropped.  Nor are the prefix-aware router's peeks at the registry
(``holds_prefix``, ``shared_page_ids``): they come with the router.

Thread contract: every method is engine-thread-only except :meth:`stats` and
:meth:`available`, which take the internal lock (the scheduler's
KV-pressure admission test calls them from client threads).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class SharedPrefix:
    """One registered shareable prefix.

    ``pages`` are the physical pages covering prompt positions
    ``[0, length)`` in logical order; all but possibly the last are full
    (``page_size`` tokens).  ``full_pages`` of them are safe to share
    physically; a partial tail page must be COW-cloned by consumers."""

    pages: Tuple[int, ...]
    length: int  # true token count of the prefix
    full_pages: int  # pages fully covered by the prefix (shareable in place)


class PageAllocator:
    """Refcounted fixed-size page pool with a shareable-prefix LRU.

    Invariants (as the JAX package's allocator):

    - every page is either on the free list or has refcount >= 1, never both;
    - ``pages_free + pages_used == n_pages`` at all times;
    - a page referenced by k live holders and m registry entries has
      refcount k + m.
    """

    def __init__(
        self,
        n_pages: int,
        page_size: int,
        *,
        page_bytes: int = 0,
        max_shared_bytes: int = 1 << 30,
        max_shared_entries: int = 8,
        min_prefix_tokens: int = 32,
    ):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError(
                f"PageAllocator needs n_pages > 0 and page_size > 0, got "
                f"({n_pages}, {page_size})"
            )
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.page_bytes = max(0, int(page_bytes))
        self.max_shared_bytes = int(max_shared_bytes)
        self.max_shared_entries = max(0, int(max_shared_entries))
        self.min_prefix_tokens = max(1, int(min_prefix_tokens))
        self._lock = threading.Lock()
        # LIFO free list: the most recently freed pages are re-used first
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self._shared: "collections.OrderedDict[tuple, SharedPrefix]" = (
            collections.OrderedDict()
        )
        self._shared_bytes = 0
        # counters (tick_stats / healthz); prefix hits and misses are counted
        # by the engine, once per admitted request (lookup runs on every
        # admission peek and would overcount while a head waits)
        self.evictions = 0  # shared entries dropped (LRU or on demand)
        self.cow_copies = 0  # boundary pages cloned for a sharer

    # ------------------------------------------------------------ core alloc
    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` free pages (refcount 1 each), evicting LRU shared
        prefixes on demand.  Returns None, allocating nothing, when the pool
        cannot satisfy the request even after evicting every entry (pinned
        pages, with a holder beside the registry, never free)."""
        if n <= 0:
            return []
        with self._lock:
            while len(self._free) < n and self._shared:
                self._evict_lru_locked()
            if len(self._free) < n:
                return None
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._refs[p] = 1
            return pages

    def incref(self, pages: Sequence[int]) -> None:
        with self._lock:
            for p in pages:
                if p not in self._refs:
                    raise ValueError(f"incref on free page {p}")
                self._refs[p] += 1

    def decref(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; pages reaching zero return to the
        free list (LIFO)."""
        with self._lock:
            self._decref_locked(pages)

    def _decref_locked(self, pages: Sequence[int]) -> None:
        for p in pages:
            r = self._refs.get(p)
            if r is None:
                raise ValueError(f"decref on free page {p}")
            if r <= 1:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = r - 1

    # ------------------------------------------------------- prefix registry
    def lookup(self, prompt_ids: Sequence[int], prefix_len: int) -> Optional[SharedPrefix]:
        """LONGEST registered prefix this prompt starts with, or None.

        Longest match (not exact key) keeps multi-turn dialogs hitting: turn
        N's prompt extends turn N-1's ``[system, ...history]`` block, so the
        previous turn's entry is a proper prefix of the new prompt even though
        the declared split point moved.  LRU-touches the winner."""
        if prefix_len < self.min_prefix_tokens:
            return None
        n = len(prompt_ids)
        with self._lock:
            best_key, best = None, None
            for key, ent in self._shared.items():
                if ent.length < n and (best is None or ent.length > best.length):
                    if tuple(prompt_ids[: ent.length]) == key:
                        best, best_key = ent, key
            if best_key is not None:
                self._shared.move_to_end(best_key)
            return best

    def register(
        self, prompt_ids: Sequence[int], prefix_len: int, pages: Sequence[int]
    ) -> bool:
        """Register the pages covering ``prompt_ids[:prefix_len]`` as a
        shareable prefix (increfs each: the registry is a holder like any
        live request).  ``pages`` must cover positions ``[0, prefix_len)`` in
        logical order: ``ceil(prefix_len / page_size)`` entries.  Returns
        False (no-op) for too-short prefixes, duplicates, or a disabled
        registry."""
        if self.max_shared_entries <= 0 or prefix_len < self.min_prefix_tokens or not pages:
            return False
        need = -(-prefix_len // self.page_size)
        if len(pages) != need:
            raise ValueError(
                f"register: prefix of {prefix_len} tokens needs {need} pages, "
                f"got {len(pages)}"
            )
        key = tuple(prompt_ids[:prefix_len])
        with self._lock:
            if key in self._shared:
                return False
            for p in pages:
                if p not in self._refs:
                    raise ValueError(f"register with free page {p}")
            ent = SharedPrefix(
                pages=tuple(pages),
                length=int(prefix_len),
                full_pages=int(prefix_len // self.page_size),
            )
            for p in ent.pages:
                self._refs[p] += 1
            self._shared[key] = ent
            self._shared_bytes += len(ent.pages) * self.page_bytes
            while self._shared and (
                len(self._shared) > self.max_shared_entries
                or (self.page_bytes and self._shared_bytes > self.max_shared_bytes)
            ):
                self._evict_lru_locked()
            # a pathological budget can make the new entry its own victim
            return key in self._shared

    def _evict_lru_locked(self) -> None:
        _, ent = self._shared.popitem(last=False)
        self._shared_bytes -= len(ent.pages) * self.page_bytes
        self._decref_locked(ent.pages)
        self.evictions += 1

    def shared_keys(self) -> List[Tuple[tuple, int, int]]:
        """Snapshot of the registry: (key, length, n_pages) per entry."""
        with self._lock:
            return [(key, ent.length, len(ent.pages)) for key, ent in self._shared.items()]

    def shared_entries(self) -> List[Tuple[tuple, SharedPrefix]]:
        """Snapshot of (key, entry) pairs, with the physical pages."""
        with self._lock:
            return list(self._shared.items())

    def reset(self) -> None:
        """Forget everything (crash-only engine restart: the device pool is
        rebuilt, so every page is free again and the registry is empty)."""
        with self._lock:
            self._free = list(range(self.n_pages - 1, -1, -1))
            self._refs.clear()
            self._shared.clear()
            self._shared_bytes = 0

    # ------------------------------------------------------------- telemetry
    @property
    def pages_free(self) -> int:
        with self._lock:
            return len(self._free)

    def _evictable_locked(self) -> int:
        """Cached-prefix pages whose only holder is the registry."""
        return sum(1 for ent in self._shared.values() for p in ent.pages if self._refs.get(p) == 1)

    def available(self) -> int:
        """Pages a new request could obtain right now: the free list plus
        every cached-prefix page whose only holder is the registry (evicting
        the entry would free it).  The scheduler's KV-pressure admission test
        compares projected demand against this."""
        with self._lock:
            return len(self._free) + self._evictable_locked()

    def stats(self) -> dict:
        with self._lock:
            used = self.n_pages - len(self._free)
            shared_pages = {p for ent in self._shared.values() for p in ent.pages}
            return {
                "kv_pages_total": self.n_pages,
                "kv_page_size": self.page_size,
                "kv_pages_used": used,
                "kv_pages_free": len(self._free),
                # free + evictable: what available() reports, the pool's
                # pressure (a warm prefix cache denies pages to nobody)
                "kv_pages_obtainable": len(self._free) + self._evictable_locked(),
                "kv_shared_pages": len(shared_pages),
                "kv_shared_page_frac": round(len(shared_pages) / used, 4) if used else 0.0,
                "kv_shared_entries": len(self._shared),
                "kv_shared_bytes": self._shared_bytes,
                "kv_evictions": self.evictions,
                "kv_cow_copies": self.cow_copies,
            }
