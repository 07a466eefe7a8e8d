"""Embedder UDFs.

The port's copy of the reference's ``xpacks/llm/embedders.py``
(upstream Pathway's python/pathway/xpacks/llm/embedders.py: BaseEmbedder
:64, SentenceTransformerEmbedder :270). ``SentenceTransformerEmbedder``
is a *batched* UDF over the port's ``SentenceEncoder``: rows are
gathered into dynamic batches and run as bf16 forwards whose layers are
the hand-written kernels (B1, B4 for long-tailed batches) on the card.
``encode_device`` keeps the embeddings on the card for the device KNN
index. The HTTP embedders (``OpenAIEmbedder`` :85, ``LiteLLMEmbedder``
:180, ``GeminiEmbedder`` :330) import their client packages when called,
as in the reference.
"""

from __future__ import annotations

import numpy as np

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


class OpenAIEmbedder(BaseEmbedder):
    """OpenAI `embeddings.create` wrapper (reference embedders.py:85).
    Network calls require the `openai` package and an API key.

    Args:
        capacity: max concurrent in-flight requests; None = unbounded.
            Rows queue in the async executor beyond this.
        retry_strategy: a ``udfs.AsyncRetryStrategy`` applied per request
            (e.g. ``udfs.ExponentialBackoffRetryStrategy``) or a shared
            ``pathway_tpu_torch.resilience.RetryPolicy`` (coerced; attempts
            surface on ``/metrics``); None = fail on first error,
            routing the row to the error log.
        cache_strategy: a ``udfs.CacheStrategy`` memoizing responses by
            input text — on a restart, previously embedded documents are
            served from the cache instead of re-billed.
        model: embedding model id; forwarded with every request.
        **openai_kwargs: forwarded verbatim to ``embeddings.create``
            (plus ``api_key``/``base_url``, which configure the shared
            client).
    """

    def __init__(
        self,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = "text-embedding-3-small",
        **openai_kwargs,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.model = model
        self.kwargs = dict(openai_kwargs)
        if model is not None:
            self.kwargs["model"] = model

    async def __wrapped__(self, input, **kwargs) -> np.ndarray:
        try:
            import openai
        except ImportError as e:  # pragma: no cover
            raise ImportError("OpenAIEmbedder requires the openai package") from e
        kwargs = {**self.kwargs, **kwargs}
        api_kwargs = {k: v for k, v in kwargs.items() if k not in ("api_key", "base_url")}
        from ._utils import shared_openai_client

        client = shared_openai_client(kwargs.get("api_key"), kwargs.get("base_url"))
        ret = await client.embeddings.create(input=[input or "."], **api_kwargs)
        return np.array(ret.data[0].embedding)


class LiteLLMEmbedder(BaseEmbedder):
    """litellm.aembedding wrapper (reference embedders.py:180): one class
    fronting every provider litellm routes to (``model`` picks the
    provider, e.g. ``"ollama/llama2"``). Same ``capacity`` /
    ``retry_strategy`` / ``cache_strategy`` semantics as
    :class:`OpenAIEmbedder`; extra kwargs go to ``litellm.aembedding``
    verbatim (``api_base``, ``api_version``, ...)."""

    def __init__(
        self,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = None,
        **llmlite_kwargs,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.kwargs = dict(llmlite_kwargs)
        if model is not None:
            self.kwargs["model"] = model

    async def __wrapped__(self, input, **kwargs) -> np.ndarray:
        try:
            import litellm
        except ImportError as e:  # pragma: no cover
            raise ImportError("LiteLLMEmbedder requires the litellm package") from e
        ret = await litellm.aembedding(input=[input or "."], **{**self.kwargs, **kwargs})
        return np.array(ret.data[0]["embedding"])


class GeminiEmbedder(BaseEmbedder):
    """google.generativeai ``embed_content`` wrapper (reference
    embedders.py:330). Same ``capacity`` / ``retry_strategy`` /
    ``cache_strategy`` semantics as :class:`OpenAIEmbedder`; extra
    kwargs (``task_type``, ``output_dimensionality``, ...) forward to
    ``embed_content`` verbatim."""

    def __init__(
        self,
        capacity: int | None = None,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        model: str | None = "models/embedding-001",
        **gemini_kwargs,
    ):
        executor = udfs.async_executor(capacity=capacity, retry_strategy=retry_strategy)
        super().__init__(executor=executor, cache_strategy=cache_strategy)
        self.kwargs = dict(gemini_kwargs)
        if model is not None:
            self.kwargs["model"] = model

    def __wrapped__(self, input, **kwargs) -> np.ndarray:
        try:
            import google.generativeai as genai
        except ImportError as e:  # pragma: no cover
            raise ImportError("GeminiEmbedder requires google-generativeai") from e
        response = genai.embed_content(content=[input or "."], **{**self.kwargs, **kwargs})
        return np.array(response["embedding"][0])
