"""pw.stdlib: the parts the port holds so far (``indexing``, ``ml``,
``ordered``, ``statistical``, ``temporal``)."""

from . import indexing, ml, ordered, statistical, temporal

__all__ = ["indexing", "ml", "ordered", "statistical", "temporal"]
