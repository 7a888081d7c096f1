"""Paged KV memory plane, host side (port of ``serving/kv_pool.py``).

Only the refcounted page allocator is here so far.  The shareable-prefix
registry (prefix sharing, copy-on-write boundary pages) and the host KV tier
wait for their slices (ROADMAP Queue 1 items 5 and 12); without a registry
``available()`` is the free-list size.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence


class PageAllocator:
    """Refcounted fixed-size page pool.

    Invariants (as the JAX package's allocator): every page is either on the
    free list or has refcount >= 1, never both; ``pages_free + pages_used ==
    n_pages`` at all times."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError(
                f"PageAllocator needs n_pages > 0 and page_size > 0, got "
                f"({n_pages}, {page_size})"
            )
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # LIFO free list: the most recently freed pages are re-used first
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` free pages (refcount 1 each), or None — allocating
        nothing — when the pool cannot satisfy the request."""
        if n <= 0:
            return []
        with self._lock:
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
            for p in pages:
                r = self._refs.get(p)
                if r is None:
                    raise ValueError(f"decref on free page {p}")
                if r <= 1:
                    del self._refs[p]
                    self._free.append(p)
                else:
                    self._refs[p] = r - 1

    @property
    def pages_free(self) -> int:
        with self._lock:
            return len(self._free)

    def available(self) -> int:
        """Pages a new request could obtain right now (the free list; the
        JAX allocator adds evictable cached-prefix pages, which need the
        prefix registry)."""
        return self.pages_free
