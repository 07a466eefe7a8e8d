"""pw.ml: ``KNNIndex`` (the reference's stdlib/ml/index.py)."""

from . import index
from .index import DistanceTypes, KNNIndex

__all__ = ["DistanceTypes", "KNNIndex", "index"]
