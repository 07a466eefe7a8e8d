"""BM25 full-text inner index.

The port's copy of the reference's ``stdlib/indexing/bm25.py`` (upstream
Pathway's python/pathway/stdlib/indexing/bm25.py: TantivyBM25 :41,
TantivyBM25Factory :109), backed by the host inverted index in
``ops/bm25.py`` in place of the Tantivy integration.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...ops.bm25 import BM25Index
from .data_index import InnerIndex
from .retrievers import InnerIndexFactory


@dataclass(frozen=True)
class TantivyBM25(InnerIndex):
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def _index_factory(self):
        ram, mem = self.ram_budget, self.in_memory_index
        return lambda: BM25Index(ram_budget=ram, in_memory_index=mem)


@dataclass
class TantivyBM25Factory(InnerIndexFactory):
    ram_budget: int = 50_000_000
    in_memory_index: bool = True

    def build_inner_index(self, data_column, metadata_column=None) -> InnerIndex:
        return TantivyBM25(
            data_column,
            metadata_column,
            ram_budget=self.ram_budget,
            in_memory_index=self.in_memory_index,
        )
