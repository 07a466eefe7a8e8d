"""LLM xpack: the port's copy of the reference's ``xpacks/llm``.

Embedders (``SentenceTransformerEmbedder`` on the port's encoder), chat
models, rerankers (``CrossEncoderReranker`` on the port's cross-encoder),
parsers, splitters, prompt templates, ``VectorStoreServer`` /
``DocumentStore``, the RAG question-answering apps, the evaluation harness
and the REST servers. The HTTP embedders come with ROADMAP Queue A item 1.
"""

from . import embedders, llms, parsers, prompts, question_answering, rag_evals, rerankers, servers, splitters
from .document_store import DocumentStore, SlidesDocumentStore
from .vector_store import SlidesVectorStoreServer, VectorStoreClient, VectorStoreServer

__all__ = [
    "DocumentStore",
    "SlidesDocumentStore",
    "SlidesVectorStoreServer",
    "VectorStoreClient",
    "VectorStoreServer",
    "embedders",
    "llms",
    "parsers",
    "prompts",
    "question_answering",
    "rag_evals",
    "rerankers",
    "servers",
    "splitters",
]
