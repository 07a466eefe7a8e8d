"""LLM xpack: the port's copy of the reference's ``xpacks/llm``.

Embedders (``SentenceTransformerEmbedder`` on the port's encoder),
parsers, splitters, prompt templates, ``VectorStoreServer`` /
``DocumentStore`` and the REST servers. Chat models, rerankers and the
question-answering apps come with ROADMAP Queue A item 2; the HTTP
embedders with item 1.
"""

from . import embedders, parsers, prompts, servers, splitters
from .document_store import DocumentStore, SlidesDocumentStore
from .vector_store import SlidesVectorStoreServer, VectorStoreClient, VectorStoreServer

__all__ = [
    "DocumentStore",
    "SlidesDocumentStore",
    "SlidesVectorStoreServer",
    "VectorStoreClient",
    "VectorStoreServer",
    "embedders",
    "parsers",
    "prompts",
    "servers",
    "splitters",
]
