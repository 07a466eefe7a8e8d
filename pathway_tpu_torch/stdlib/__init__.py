"""pw.stdlib: the parts the port holds so far (``indexing``, ``ml``)."""

from . import indexing, ml

__all__ = ["indexing", "ml"]
