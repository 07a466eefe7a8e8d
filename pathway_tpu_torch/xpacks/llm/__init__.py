"""LLM xpack: ``embedders.SentenceTransformerEmbedder`` on the port's encoder."""

from . import embedders

__all__ = ["embedders"]
