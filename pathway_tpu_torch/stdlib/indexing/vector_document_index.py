"""Default document-index builders.

The port's copy of the reference's
``stdlib/indexing/vector_document_index.py`` (upstream Pathway's
python/pathway/stdlib/indexing/vector_document_index.py:12-154).
"""

from __future__ import annotations

from typing import Callable

from ...internals.table import Table
from .bm25 import TantivyBM25Factory
from .data_index import DataIndex
from .nearest_neighbors import (
    BruteForceKnnFactory,
    LshKnnFactory,
    UsearchKnnFactory,
)


def VectorDocumentIndex(
    data_column,
    data_table: Table,
    embedder: Callable | None = None,
    *,
    dimensions: int = 0,
    metadata_column=None,
    factory=None,
) -> DataIndex:
    if factory is None:
        factory = BruteForceKnnFactory(dimensions=dimensions, embedder=embedder)
    return factory.build_index(data_column, data_table, metadata_column)


def default_vector_document_index(
    data_column,
    data_table: Table,
    *,
    embedder: Callable | None = None,
    dimensions: int = 0,
    metadata_column=None,
) -> DataIndex:
    factory = BruteForceKnnFactory(dimensions=dimensions, embedder=embedder)
    return factory.build_index(data_column, data_table, metadata_column)


def default_brute_force_knn_document_index(
    data_column,
    data_table: Table,
    *,
    embedder: Callable | None = None,
    dimensions: int = 0,
    metadata_column=None,
) -> DataIndex:
    factory = BruteForceKnnFactory(dimensions=dimensions, embedder=embedder)
    return factory.build_index(data_column, data_table, metadata_column)


def default_usearch_knn_document_index(
    data_column,
    data_table: Table,
    *,
    embedder: Callable | None = None,
    dimensions: int = 0,
    metadata_column=None,
) -> DataIndex:
    factory = UsearchKnnFactory(dimensions=dimensions, embedder=embedder)
    return factory.build_index(data_column, data_table, metadata_column)


def default_lsh_knn_document_index(
    data_column,
    data_table: Table,
    *,
    embedder: Callable | None = None,
    dimensions: int = 0,
    metadata_column=None,
) -> DataIndex:
    factory = LshKnnFactory(dimensions=dimensions, embedder=embedder)
    return factory.build_index(data_column, data_table, metadata_column)


def default_full_text_document_index(
    data_column,
    data_table: Table,
    *,
    metadata_column=None,
) -> DataIndex:
    factory = TantivyBM25Factory()
    return factory.build_index(data_column, data_table, metadata_column)
