"""Embedder UDFs.

The port's copy of the reference's ``xpacks/llm/embedders.py``
(upstream Pathway's python/pathway/xpacks/llm/embedders.py: BaseEmbedder
:64, SentenceTransformerEmbedder :270). ``SentenceTransformerEmbedder``
is a *batched* UDF over the port's ``SentenceEncoder``: rows are
gathered into dynamic batches and run as bf16 forwards whose layers are
the hand-written kernels (B1, B4 for long-tailed batches) on the card.
``encode_device`` keeps the embeddings on the card for the device KNN
index. The HTTP embedders (OpenAI, LiteLLM, Gemini) come with the vector
store, ROADMAP Queue A item 1.
"""

from __future__ import annotations

from ...internals import udfs
from ...internals.expression import ColumnExpression
from ._utils import _coerce_sync


class BaseEmbedder(udfs.UDF):
    """Base class for embedders: ``__wrapped__(text) -> np.ndarray``."""

    def __call__(self, input: ColumnExpression, **kwargs) -> ColumnExpression:
        return super().__call__(input, **kwargs)

    def get_embedding_dimension(self, **kwargs) -> int:
        """Embed a probe string and measure the vector length
        (reference embedders.py:74-84)."""
        fn = self.func if self.func is not None else self.__wrapped__
        result = _coerce_sync(fn)(".", **kwargs)
        return len(result)


class SentenceTransformerEmbedder(BaseEmbedder):
    """The sentence_transformers hot path (reference embedders.py:270-329)
    on the port's encoder. ``model`` picks a MiniLM config; weights load
    from ``PATHWAY_TPU_CKPT`` when it holds a checkpoint, otherwise the
    encoder runs with seeded random weights, as in the reference.
    ``device``: ``None`` runs on ``"cuda"`` (and raises without a card);
    ``"cpu"`` only when asked. ``mesh``: embed data-parallel over the mesh's
    data devices (``SentenceEncoder(mesh=)``; a spec resolves on the CPU
    with ``device="cpu"``).
    """

    def __init__(
        self,
        model: str = "all-MiniLM-L6-v2",
        call_kwargs: dict = {},
        device: str | None = None,
        *,
        max_batch_size: int = 1024,
        mesh=None,
        **init_kwargs,
    ):
        executor = init_kwargs.pop("executor", None)
        if executor is None:
            executor = udfs.batch_executor(max_batch_size=max_batch_size)
        super().__init__(executor=executor, **init_kwargs)
        from ...models.sentence_encoder import SentenceEncoder

        self._encoder = SentenceEncoder(model, max_batch=max_batch_size, device=device, mesh=mesh)
        self.kwargs = dict(call_kwargs)

    def __wrapped__(self, input, **kwargs):
        # batch_executor delivers a list of rows; plain call delivers one
        if isinstance(input, list):
            texts = ["" if t is None else str(t) for t in input]
            embs = self._encoder.encode(texts)
            return [e for e in embs]
        return self._encoder.encode([str(input)])[0]

    def encode_device(self, texts, pad_to: int | None = None):
        """Batch ingest surface: texts -> device-resident [n, dim] f32
        tensor (no host round trip; feeds the device KNN index)."""
        return self._encoder.encode_device(texts, pad_to=pad_to)

    def encode_device_many(self, batches, pad_to: int | None = None) -> list:
        """Staged multi-batch ingest: batch i+1 tokenizes on the host while
        batch i's device work is in flight. One device tensor per batch."""
        return self._encoder.encode_device_many(batches, pad_to=pad_to)

    def get_embedding_dimension(self, **kwargs) -> int:
        return self._encoder.dim
