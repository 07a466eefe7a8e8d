"""In-memory BM25 full-text index (host-side inverted index).

The port's copy of the reference's ``ops/bm25.py``, which replaces
upstream Pathway's Tantivy integration
(src/external_integration/tantivy_integration.rs). Text scoring is
pointer-chasing over small posting lists, a host workload, so it stays in
Python with the same retraction-aware add/remove/search surface as the
KNN index.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Any, Callable

_TOKEN = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> list[str]:
    return _TOKEN.findall((text or "").lower())


class BM25Index:
    def __init__(self, k1: float = 1.2, b: float = 0.75, ram_budget: int = 0, in_memory_index: bool = True):
        # ram_budget / in_memory_index: reference-parity args (TantivyBM25)
        self.k1 = k1
        self.b = b
        self._docs: dict[Any, Counter] = {}
        self._len: dict[Any, int] = {}
        self._meta: dict[Any, Any] = {}
        self._postings: dict[str, dict[Any, int]] = {}
        self._total_len = 0

    def __len__(self) -> int:
        return len(self._docs)

    def add(self, key, text: str, metadata=None) -> None:
        if key in self._docs:
            self.remove(key)
        toks = Counter(tokenize(text))
        self._docs[key] = toks
        n = sum(toks.values())
        self._len[key] = n
        self._total_len += n
        if metadata is not None:
            self._meta[key] = metadata
        for t, c in toks.items():
            self._postings.setdefault(t, {})[key] = c

    def remove(self, key) -> None:
        toks = self._docs.pop(key, None)
        if toks is None:
            return
        self._total_len -= self._len.pop(key, 0)
        self._meta.pop(key, None)
        for t in toks:
            p = self._postings.get(t)
            if p is not None:
                p.pop(key, None)
                if not p:
                    del self._postings[t]

    def search_one(self, query: str, k: int, filter_fn: Callable | None = None) -> list[tuple[Any, float]]:
        n_docs = len(self._docs)
        if n_docs == 0:
            return []
        avg_len = self._total_len / n_docs
        scores: dict[Any, float] = {}
        for t in set(tokenize(query)):
            posting = self._postings.get(t)
            if not posting:
                continue
            df = len(posting)
            idf = math.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
            for key, tf in posting.items():
                dl = self._len[key]
                s = idf * tf * (self.k1 + 1) / (
                    tf + self.k1 * (1 - self.b + self.b * dl / avg_len)
                )
                scores[key] = scores.get(key, 0.0) + s
        items = sorted(scores.items(), key=lambda kv: -kv[1])
        out = []
        for key, s in items:
            if filter_fn is not None:
                try:
                    if not filter_fn(self._meta.get(key)):
                        continue
                except Exception:
                    continue
            out.append((key, float(s)))
            if len(out) == k:
                break
        return out

    def search_batch(self, queries, k: int, filter_fns=None):
        return [
            self.search_one(q, k, filter_fns[i] if filter_fns else None)
            for i, q in enumerate(queries)
        ]
