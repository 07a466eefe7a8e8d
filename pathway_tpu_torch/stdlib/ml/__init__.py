"""pw.ml (reference stdlib/ml/): index (KNN), classifiers (LSH),
smart_table_ops (fuzzy join), hmm, datasets."""

from . import classifiers, datasets, hmm, index, smart_table_ops, utils
from .hmm import create_hmm_reducer
from .index import KNNIndex, DistanceTypes
from .smart_table_ops import (
    fuzzy_match,
    fuzzy_match_tables,
    fuzzy_match_with_hint,
    fuzzy_self_match,
    smart_fuzzy_match,
)

__all__ = [
    "classifiers",
    "utils",
    "datasets",
    "create_hmm_reducer",
    "DistanceTypes",
    "fuzzy_match",
    "fuzzy_match_tables",
    "fuzzy_match_with_hint",
    "fuzzy_self_match",
    "hmm",
    "index",
    "KNNIndex",
    "smart_fuzzy_match",
    "smart_table_ops",
]
