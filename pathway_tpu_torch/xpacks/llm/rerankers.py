"""Reranker UDFs.

The port's copy of the reference's ``xpacks/llm/rerankers.py`` (upstream
Pathway's xpacks/llm/rerankers.py: rerank_topk_filter :15, LLMReranker :58,
CrossEncoderReranker :186, EncoderReranker :251, FlashRankReranker :319).

``CrossEncoderReranker`` scores rows in dynamic batches through the port's
``CrossEncoderScorer`` (its attention is kernel B3 on the card), and
``EncoderReranker`` through the port's ``SentenceEncoder``.
``FlashRankReranker`` imports ``flashrank`` when it is built.
"""

from __future__ import annotations

import re
from typing import Any

from ...engine.value import Json
from ...internals import udfs
from ...internals.expression import ColumnExpression
from .llms import BaseChat


@udfs.udf
def rerank_topk_filter(
    docs: list[dict], scores: list[float], k: int = 5
) -> tuple[list[dict], list[float]]:
    """Keep the k best-scored docs (reference rerankers.py:15).
    Returns (docs, scores) sorted by score descending."""
    docs = [d.value if isinstance(d, Json) else d for d in docs]
    order = sorted(zip(docs, scores), key=lambda p: p[1], reverse=True)[: int(k)]
    if not order:
        return [], []
    top_docs, top_scores = zip(*order)
    return list(top_docs), list(top_scores)


class LLMReranker(udfs.UDF):
    """Ask a chat model to rate doc relevance 1-5 (reference rerankers.py:58)."""

    def __init__(
        self,
        llm: BaseChat,
        *,
        retry_strategy: udfs.AsyncRetryStrategy | None = None,
        cache_strategy: udfs.CacheStrategy | None = None,
        use_logit_bias: bool | None = None,
    ):
        super().__init__(
            executor=(
                udfs.async_executor(retry_strategy=retry_strategy)
                if retry_strategy is not None
                else None
            ),
            cache_strategy=cache_strategy,
        )
        self.llm = llm
        if use_logit_bias is None:
            use_logit_bias = getattr(llm, "_accepts_call_arg", lambda _a: False)("logit_bias")
        self.use_logit_bias = use_logit_bias
        # bias toward the digit tokens "1".."5" (cl100k ids 16-20), the
        # reference's rating constraint (rerankers.py:140)
        self.number_biases = {str(tok): 50 for tok in range(16, 21)}

    def _build_prompt(self, doc: str, query: str) -> list[dict]:
        return [
            {
                "role": "system",
                "content": (
                    "Rate how relevant the document is to the query on an "
                    "integer scale from 1 (irrelevant) to 5 (highly "
                    "relevant). Respond with the number only."
                ),
            },
            {"role": "user", "content": f"Query: {query}\nDocument: {doc}"},
        ]

    def get_first_number(self, text: str) -> int:
        m = re.search(r"\d", text or "")
        if m is None:
            raise ValueError(f"LLMReranker got unparsable rating: {text!r}")
        return int(m.group())

    def __wrapped__(self, doc: str, query: str, **kwargs) -> float:
        fn = self.llm.func if self.llm.func is not None else self.llm.__wrapped__
        from ._utils import _coerce_sync

        if self.use_logit_bias:
            kwargs.setdefault("logit_bias", self.number_biases)
        response = _coerce_sync(fn)(Json(self._build_prompt(doc, query)), **kwargs)
        return float(self.get_first_number(response))

    def __call__(
        self, doc: ColumnExpression, query: ColumnExpression, **kwargs
    ) -> ColumnExpression:
        # the graph's record of its HTTP LLM stages (the verifier's PWL013
        # reads it)
        from ...internals.parse_graph import G

        G.llm_endpoints.append(
            {
                "kind": "llm_reranker",
                "model": getattr(self.llm, "model", None),
            }
        )
        return super().__call__(doc, query, **kwargs)


class CrossEncoderReranker(udfs.UDF):
    """Joint (query, doc) scoring (reference rerankers.py:186) through
    ``CrossEncoderScorer``: rows batched dynamically, one forward per padded
    bucket, each batch under the ``rerank`` span and chip-ledger account
    (``models.reranker.scored``). ``init_kwargs`` go to the scorer
    (``device=``, ``config=``, ``params=``, ``seed=``...)."""

    def __init__(
        self,
        model_name: str = "cross-encoder/ms-marco-MiniLM-L-6-v2",
        *,
        cache_strategy: udfs.CacheStrategy | None = None,
        max_batch_size: int = 256,
        **init_kwargs,
    ):
        super().__init__(
            executor=udfs.batch_executor(max_batch_size=max_batch_size),
            cache_strategy=cache_strategy,
        )
        from ...models.sentence_encoder import CrossEncoderScorer

        self._scorer = CrossEncoderScorer(model_name, **init_kwargs)

    def __wrapped__(self, doc, query, **kwargs):
        from ...models.reranker import scored

        if isinstance(doc, list):
            return scored(self._scorer, [(str(q), str(d)) for d, q in zip(doc, query)])
        return scored(self._scorer, [(str(query), str(doc))])[0]

    def __call__(
        self, doc: ColumnExpression, query: ColumnExpression, **kwargs
    ) -> ColumnExpression:
        return super().__call__(doc, query, **kwargs)


class EncoderReranker(udfs.UDF):
    """Bi-encoder cosine-similarity reranker (reference rerankers.py:251)
    on the port's sentence encoder."""

    def __init__(
        self,
        model_name: str = "all-MiniLM-L6-v2",
        *,
        cache_strategy: udfs.CacheStrategy | None = None,
        max_batch_size: int = 512,
        **init_kwargs,
    ):
        super().__init__(
            executor=udfs.batch_executor(max_batch_size=max_batch_size),
            cache_strategy=cache_strategy,
        )
        from ...models.sentence_encoder import SentenceEncoder

        self._encoder = SentenceEncoder(model_name, **init_kwargs)

    def _score_batch(self, docs: list[str], queries: list[str]) -> list[float]:
        import numpy as np

        embs = self._encoder.encode([*docs, *queries])
        d, q = embs[: len(docs)], embs[len(docs):]
        # embeddings are L2-normalized: cosine = dot
        return [float(x) for x in np.sum(d * q, axis=1)]

    def __wrapped__(self, doc, query, **kwargs):
        if isinstance(doc, list):
            return self._score_batch([str(x) for x in doc], [str(x) for x in query])
        return self._score_batch([str(doc)], [str(query)])[0]

    def __call__(
        self, doc: ColumnExpression, query: ColumnExpression, **kwargs
    ) -> ColumnExpression:
        return super().__call__(doc, query, **kwargs)


class FlashRankReranker(udfs.UDF):
    """flashrank wrapper (reference rerankers.py:319); requires the
    optional `flashrank` package."""

    def __init__(
        self,
        model_name: str = "ms-marco-TinyBERT-L-2-v2",
        *,
        cache_strategy: udfs.CacheStrategy | None = None,
        max_length: int = 512,
    ):
        super().__init__(cache_strategy=cache_strategy)
        try:
            from flashrank import Ranker
        except ImportError as e:  # pragma: no cover
            raise ImportError("FlashRankReranker requires the flashrank package") from e
        self._ranker = Ranker(model_name=model_name, max_length=max_length)

    def __wrapped__(self, doc: str, query: str) -> float:
        from flashrank import RerankRequest

        req = RerankRequest(query=query, passages=[{"text": doc}])
        return float(self._ranker.rerank(req)[0]["score"])

    def __call__(
        self, doc: ColumnExpression, query: ColumnExpression, **kwargs
    ) -> ColumnExpression:
        return super().__call__(doc, query, **kwargs)
