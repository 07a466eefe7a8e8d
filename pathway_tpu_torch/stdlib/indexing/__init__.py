"""pw.indexing — the retriever API (the reference's stdlib/indexing/):
``DataIndex`` over KNN, BM25 and hybrid inner indexes, and the default
document indexes. The sorted index comes with ROADMAP Queue A item 7."""

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
from .retrievers import AbstractRetrieverFactory, InnerIndexFactory
from .vector_document_index import (
    VectorDocumentIndex,
    default_brute_force_knn_document_index,
    default_full_text_document_index,
    default_lsh_knn_document_index,
    default_usearch_knn_document_index,
    default_vector_document_index,
)

# reference capitalization alias
USearchKnn = UsearchKnn

__all__ = [
    "AbstractKnn",
    "AbstractRetrieverFactory",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "BruteForceKnnMetricKind",
    "DataIndex",
    "HybridIndex",
    "HybridIndexFactory",
    "InnerIndex",
    "InnerIndexFactory",
    "KnnIndexFactory",
    "LshKnn",
    "LshKnnFactory",
    "TantivyBM25",
    "TantivyBM25Factory",
    "USearchKnn",
    "USearchMetricKind",
    "UsearchKnn",
    "UsearchKnnFactory",
    "VectorDocumentIndex",
    "default_brute_force_knn_document_index",
    "default_full_text_document_index",
    "default_lsh_knn_document_index",
    "default_usearch_knn_document_index",
    "default_vector_document_index",
    "_INDEX_REPLY",
    "_SCORE",
]
