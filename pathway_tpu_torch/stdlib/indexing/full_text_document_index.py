"""Default full-text document index: the port's copy of the reference's
``stdlib/indexing/full_text_document_index.py`` (upstream Pathway's
layout, full_text_document_index.py:1-26); the BM25-backed constructor
lives in vector_document_index beside the other defaults."""

from .vector_document_index import default_full_text_document_index

__all__ = ["default_full_text_document_index"]
