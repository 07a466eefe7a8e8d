"""Hybrid retrieval: reciprocal-rank fusion over several inner indexes.

The port's copy of the reference's ``stdlib/indexing/hybrid_index.py``
(upstream Pathway's python/pathway/stdlib/indexing/hybrid_index.py:
HybridIndex :14, RRF merge :35-120, HybridIndexFactory :159). Each
sub-index receives the same raw payload (typically text) and applies its
own batch embedder; ranks are merged with score = sum 1/(k + rank). A
sub-embedder that returns a device tensor feeds a sub-index with
``add_batch_device`` (the port's ``DeviceKnnIndex``) on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from .data_index import InnerIndex
from .retrievers import InnerIndexFactory


class _HybridEngineIndex:
    def __init__(self, subs: list, embeds: list, k: float):
        self.subs = subs
        self.embeds = embeds  # per sub: (data_embed, query_embed) or (None, None)
        self.k = k

    def add_batch(self, items: list[tuple]) -> None:
        if not items:
            return
        payloads = [p for _, p, _ in items]
        for sub, (de, _) in zip(self.subs, self.embeds):
            sub_payloads = de(payloads) if de is not None else payloads
            if isinstance(sub_payloads, torch.Tensor):
                # device-embedder output (possibly padded to a bucket
                # size): keep it on the device when the sub-index can take
                # it; otherwise one bulk fetch, not per-row
                if hasattr(sub, "add_batch_device"):
                    sub.add_batch_device(
                        [k for k, _, _ in items],
                        sub_payloads,
                        [m for _, _, m in items],
                    )
                    continue
                sub_payloads = sub_payloads[: len(items)].float().cpu().numpy()
            for (key, _, meta), p in zip(items, sub_payloads):
                sub.add(key, p, meta)

    def add(self, key, payload, metadata=None) -> None:
        self.add_batch([(key, payload, metadata)])

    def remove(self, key) -> None:
        for sub in self.subs:
            sub.remove(key)

    def search_batch(self, payloads, k: int, filter_fns=None):
        per_sub = []
        for sub, (_, qe) in zip(self.subs, self.embeds):
            sub_payloads = qe(payloads) if qe is not None else payloads
            per_sub.append(sub.search_batch(sub_payloads, k, filter_fns))
        out = []
        for qi in range(len(payloads)):
            fused: dict[Any, float] = {}
            for sub_results in per_sub:
                for rank, (key, _score) in enumerate(sub_results[qi]):
                    fused[key] = fused.get(key, 0.0) + 1.0 / (self.k + rank + 1)
            ranked = sorted(fused.items(), key=lambda kv: -kv[1])[:k]
            out.append([(key, float(s)) for key, s in ranked])
        return out


@dataclass(frozen=True)
class HybridIndex(InnerIndex):
    retrievers: list[InnerIndex] = field(default_factory=list)
    k: float = 60.0

    def __init__(self, retrievers: list[InnerIndex], k: float = 60.0):
        first = retrievers[0]
        object.__setattr__(self, "data_column", first.data_column)
        object.__setattr__(self, "metadata_column", first.metadata_column)
        object.__setattr__(self, "retrievers", retrievers)
        object.__setattr__(self, "k", k)

    def _index_factory(self):
        factories = [r._index_factory() for r in self.retrievers]
        embeds = [r._embed_fns() for r in self.retrievers]
        k = self.k
        return lambda: _HybridEngineIndex([f() for f in factories], embeds, k)

    def _embed_fns(self):
        return None, None  # per-sub embedding happens inside the engine index


@dataclass
class HybridIndexFactory(InnerIndexFactory):
    retriever_factories: list[InnerIndexFactory] = field(default_factory=list)
    k: float = 60.0

    def __init__(self, retriever_factories: list[InnerIndexFactory], k: float = 60.0):
        self.retriever_factories = retriever_factories
        self.k = k

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        inners = [
            f.build_inner_index(data_column, metadata_column)
            for f in self.retriever_factories
        ]
        return HybridIndex(inners, k=self.k)
