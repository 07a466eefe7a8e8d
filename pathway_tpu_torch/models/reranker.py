"""On-device cross-encoder reranker.

Port of ``pathway_tpu/models/reranker.py``: ``DeviceReranker`` scores
(query, candidate) pairs through a ``CrossEncoderScorer`` (whose attention
is kernel B3 on the card) and ``as_reranker`` coerces the ``rerank=`` knob.
The scorer is built lazily on the first scored batch, so declaring a
reranker costs nothing until a query flows. The reference's chip-ledger
timing and tracing span come with the index planes (ROADMAP Queue A).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

__all__ = ["DeviceReranker", "as_reranker"]


class DeviceReranker:
    """Scores query x candidate pairs with an on-device cross-encoder.

    ``scorer`` may be a prebuilt
    :class:`~pathway_tpu_torch.models.sentence_encoder.CrossEncoderScorer`;
    otherwise one is built lazily from the remaining kwargs on first use
    (``config=`` a tiny ``EncoderConfig`` and ``device="cpu"`` in tests).
    """

    def __init__(self, scorer=None, **scorer_kwargs: Any):
        self._scorer = scorer
        self._scorer_kwargs = scorer_kwargs
        self._lock = threading.Lock()

    @property
    def scorer(self):
        if self._scorer is None:
            with self._lock:
                if self._scorer is None:
                    from .sentence_encoder import CrossEncoderScorer

                    self._scorer = CrossEncoderScorer(**self._scorer_kwargs)
        return self._scorer

    def score(self, pairs) -> list[float]:
        """Relevance score per (query, doc) text pair, higher is better."""
        if not pairs:
            return []
        return [float(s) for s in self.scorer.score(list(pairs))]

    def order(self, query: str, docs) -> tuple[int, ...]:
        """Permutation of ``docs`` by descending score (stable: ties keep
        retrieval order)."""
        docs = list(docs)
        if len(docs) <= 1:
            return tuple(range(len(docs)))
        scores = self.score([(str(query), str(d)) for d in docs])
        return tuple(sorted(range(len(docs)), key=lambda i: (-scores[i], i)))

    def rerank(self, query: str, docs, k: Optional[int] = None) -> list[tuple[Any, float]]:
        """``docs`` reordered by score, with scores, top ``k``."""
        docs = list(docs)
        scores = self.score([(str(query), str(d)) for d in docs])
        order = sorted(range(len(docs)), key=lambda i: (-scores[i], i))
        if k is not None:
            order = order[:k]
        return [(docs[i], scores[i]) for i in order]


def as_reranker(spec: Any) -> DeviceReranker | None:
    """Coerce the ``rerank=`` knob: ``None``/``False``/``"off"`` -> no
    rerank; ``True``/``"auto"``/``"device"`` -> the default reranker; a
    :class:`DeviceReranker` passes through; another string names the model;
    a dict becomes scorer kwargs; an object with ``.score`` is the scorer."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, DeviceReranker):
        return spec
    if spec is True:
        return DeviceReranker()
    if isinstance(spec, str):
        text = spec.strip().lower()
        if text in ("off", "none", "false", ""):
            return None
        if text in ("on", "true", "auto", "device"):
            return DeviceReranker()
        return DeviceReranker(model=spec)
    if isinstance(spec, dict):
        return DeviceReranker(**spec)
    if hasattr(spec, "score"):
        return DeviceReranker(scorer=spec)
    raise ValueError(f"rerank: cannot coerce {type(spec).__name__} into a device reranker")
