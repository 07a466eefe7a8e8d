"""Refcounted, hash-addressed prefix cache over the paged-KV pool.

The port's copy of the reference's ``decode/prefix_cache.py``. RAG
requests share system prompts and retrieved context, so their prompts
agree on long prefixes. A new request *maps* the pages that hold an
already-prefilled prefix instead of recomputing them. Such pages are never
written: a holder's decode writes land at or past its prompt length, which
is at or past the shared prefix, and only *full* pages are cached (the
final partial page, the one place a write could land, is never shared).

Addressing is a per-page hash chain: page ``i`` of a prompt is keyed by
``H(model_version, tokens[0 : (i+1)*page_size])`` computed incrementally,
so a lookup walks the chain to the first miss and maps every page before
it. The chain gives eviction its rule: an interior page may never outlive
its descendants, so only *leaf* entries are evictable, LRU first, and only
when no request holds them (pool refcount 1, the cache's own hold).

Every mutation happens under one lock, so a lookup racing an eviction
either acquires the page (refcount raised before the lock drops: eviction
skips it) or misses cleanly. The cache stores page ids, never KV bytes,
and the pool counts a shared physical page once in ``pages_in_use``.
"""

from __future__ import annotations

import hashlib
import threading

__all__ = ["PrefixCache"]


class _Entry:
    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key: bytes, page: int, parent: bytes | None):
        self.key = key
        self.page = page
        self.parent = parent
        self.children = 0
        self.last_used = 0


def _chain_keys(tokens, page_size: int, n_pages: int, model_version: str):
    """Keys for the first ``n_pages`` full pages of ``tokens``."""
    h = hashlib.blake2b(model_version.encode(), digest_size=16)
    keys = []
    for i in range(n_pages):
        page_toks = tokens[i * page_size : (i + 1) * page_size]
        h.update(b"".join(int(t).to_bytes(8, "little", signed=True) for t in page_toks))
        keys.append(h.digest())
    return keys


class PrefixCache:
    """Maps full prompt pages already resident in a :class:`PagedKvPool`
    to new requests whose prompts share the prefix."""

    def __init__(self, pool, *, page_size: int, model_version: str = ""):
        self._pool = pool
        self._page_size = page_size
        self._model_version = model_version
        self._entries: dict[bytes, _Entry] = {}
        self._tick = 0
        self._lock = threading.Lock()

    @property
    def cached_pages(self) -> int:
        with self._lock:
            return len(self._entries)

    def _shareable_pages(self, prompt_len: int) -> int:
        # Only full pages are shareable, and the last prompt token is
        # always re-prefilled so the hit path still produces first-token
        # logits — cap the shared span at prompt_len - 1 tokens.
        return max(0, prompt_len - 1) // self._page_size

    def lookup(self, tokens) -> list[int]:
        """Map the longest cached full-page prefix of ``tokens``.

        Returns the shared physical page ids in prefix order, with one
        pool reference acquired per page on the caller's behalf (release
        with ``pool.free`` when the request retires). Empty list = cold.
        """
        n = self._shareable_pages(len(tokens))
        if not n:
            return []
        keys = _chain_keys(tokens, self._page_size, n, self._model_version)
        with self._lock:
            self._tick += 1
            pages: list[int] = []
            for key in keys:
                entry = self._entries.get(key)
                if entry is None:
                    break
                entry.last_used = self._tick
                pages.append(entry.page)
            if pages:
                # acquire inside the lock: eviction can no longer take
                # these pages from under the caller
                self._pool.share(pages)
            return pages

    def publish(self, tokens, pages, prompt_len: int) -> int:
        """Donate a freshly prefilled prompt's full pages to the cache.

        ``pages`` is the request's page table in prefix order (shared
        hits first, then privately prefilled pages). Each full page not
        already cached gains a cache-owned reference; the request keeps
        its own reference either way. Returns the count of newly cached
        pages."""
        n = min(self._shareable_pages(prompt_len), len(pages))
        if not n:
            return 0
        keys = _chain_keys(tokens, self._page_size, n, self._model_version)
        added = 0
        with self._lock:
            self._tick += 1
            parent: bytes | None = None
            for key, page in zip(keys, pages[:n]):
                entry = self._entries.get(key)
                if entry is None:
                    entry = _Entry(key, int(page), parent)
                    self._entries[key] = entry
                    if parent is not None:
                        self._entries[parent].children += 1
                    self._pool.share([int(page)])
                    added += 1
                entry.last_used = self._tick
                parent = key
        return added

    # -- eviction ------------------------------------------------------

    def _evictable(self):
        # leaves only (chain integrity: an interior page never outlives
        # its descendants) and only pages nobody but the cache holds
        return [
            e
            for e in self._entries.values()
            if e.children == 0 and self._pool.refcount(e.page) == 1
        ]

    def _evict_entry(self, entry: _Entry) -> None:
        # caller holds the lock; removal from the map and the physical
        # free happen in the same critical section — no lookup can
        # acquire a half-evicted page
        del self._entries[entry.key]
        if entry.parent is not None and entry.parent in self._entries:
            self._entries[entry.parent].children -= 1
        self._pool.free([entry.page])

    def reclaim(self, need: int) -> int:
        """Evict idle entries (LRU leaves first) until ``need`` pages
        are freed or nothing more is evictable. Returns pages freed."""
        freed = 0
        with self._lock:
            while freed < need:
                candidates = self._evictable()
                if not candidates:
                    break
                victim = min(candidates, key=lambda e: e.last_used)
                self._evict_entry(victim)
                freed += 1
        return freed

    def clear(self) -> int:
        """Drop every idle entry (held pages stay cached — they cannot
        be torn out of holders' page tables)."""
        return self.reclaim(len(self._entries))
