"""pathway_tpu_torch: the PyTorch/CUDA port of pathway_tpu's device layer.

The main path of this package: host tokenizer -> ``SentenceEncoder``
(MiniLM-L6 encoder whose layers run as hand-written Hopper kernels, with
sequence-packed ingest for long-tailed batches) -> ``DeviceKnnIndex`` (a
device-resident slab searched by a fused top-k kernel). The RAG answer
plane builds on it: ``CrossEncoderScorer`` / ``DeviceReranker`` rerank,
``FusedRagPipeline`` runs embed -> retrieve -> rerank -> generate without a
host round trip, and ``DecodeEngine`` generates with continuous batching
over a paged KV pool. Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"``. The package imports torch and numpy only.
"""

from .decode import DecodeConfig, DecodeEngine, DecoderConfig
from .device import resolve_device
from .models.encoder import EncoderConfig
from .models.reranker import DeviceReranker, as_reranker
from .models.sentence_encoder import CrossEncoderScorer, SentenceEncoder
from .ops.fused_rag import FusedRagPipeline
from .ops.knn import DeviceKnnIndex

__all__ = [
    "CrossEncoderScorer",
    "DecodeConfig",
    "DecodeEngine",
    "DecoderConfig",
    "DeviceKnnIndex",
    "DeviceReranker",
    "EncoderConfig",
    "FusedRagPipeline",
    "SentenceEncoder",
    "as_reranker",
    "resolve_device",
]
