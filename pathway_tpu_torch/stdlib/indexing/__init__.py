"""pw.indexing — unified retriever API (reference stdlib/indexing/)."""

from .bm25 import TantivyBM25, TantivyBM25Factory
from .colnames import _INDEX_REPLY, _SCORE
from .data_index import DataIndex, InnerIndex
from .hybrid_index import HybridIndex, HybridIndexFactory
from .nearest_neighbors import (
    AbstractKnn,
    BruteForceKnn,
    BruteForceKnnFactory,
    BruteForceKnnMetricKind,
    KnnIndexFactory,
    LshKnn,
    LshKnnFactory,
    USearchMetricKind,
    UsearchKnn,
    UsearchKnnFactory,
)

# reference capitalization alias (stdlib/indexing/nearest_neighbors.py:65)
USearchKnn = UsearchKnn
from .retrievers import AbstractRetrieverFactory, InnerIndexFactory
from .sorting import (
    SortedIndex,
    build_sorted_index,
    retrieve_prev_next_values,
    sort_from_index,
)
from .vector_document_index import (
    VectorDocumentIndex,
    default_brute_force_knn_document_index,
    default_full_text_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)

__all__ = [
    "DataIndex",
    "InnerIndex",
    "AbstractRetrieverFactory",
    "InnerIndexFactory",
    "AbstractKnn",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "BruteForceKnnMetricKind",
    "KnnIndexFactory",
    "LshKnn",
    "LshKnnFactory",
    "USearchKnn",
    "UsearchKnn",
    "UsearchKnnFactory",
    "USearchMetricKind",
    "TantivyBM25",
    "TantivyBM25Factory",
    "HybridIndex",
    "HybridIndexFactory",
    "VectorDocumentIndex",
    "default_vector_document_index",
    "default_brute_force_knn_document_index",
    "default_usearch_knn_document_index",
    "default_lsh_knn_document_index",
    "default_full_text_document_index",
    "SortedIndex",
    "build_sorted_index",
    "sort_from_index",
    "retrieve_prev_next_values",
    "_INDEX_REPLY",
    "_SCORE",
]
