"""Standard library (reference python/pathway/stdlib/)."""

from . import graphs, indexing, ml, ordered, statistical, stateful, temporal, utils, viz

__all__ = [
    "graphs",
    "indexing",
    "ml",
    "ordered",
    "statistical",
    "stateful",
    "temporal",
    "utils",
    "viz",
]
