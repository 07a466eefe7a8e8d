"""pw.indexing — the retriever API (the reference's stdlib/indexing/):
``DataIndex`` over a KNN inner index. BM25, hybrid and sorted indexes
come with ROADMAP Queue A item 1."""

from .colnames import _INDEX_REPLY, _SCORE
from .data_index import DataIndex, InnerIndex
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

# reference capitalization alias
USearchKnn = UsearchKnn

__all__ = [
    "AbstractKnn",
    "AbstractRetrieverFactory",
    "BruteForceKnn",
    "BruteForceKnnFactory",
    "BruteForceKnnMetricKind",
    "DataIndex",
    "InnerIndex",
    "InnerIndexFactory",
    "KnnIndexFactory",
    "LshKnn",
    "LshKnnFactory",
    "USearchKnn",
    "USearchMetricKind",
    "UsearchKnn",
    "UsearchKnnFactory",
    "_INDEX_REPLY",
    "_SCORE",
]
