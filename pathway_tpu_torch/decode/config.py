"""Decode-plane configuration.

Port of ``pathway_tpu/decode/config.py::DecodeConfig``: the same fields,
defaults and validation, plus ``pages_per_seq`` and the pool sizing. The
spec parser and the run-scoped active config come with the serving
slice. The pool budget is ``PATHWAY_HBM_BYTES`` or 16 GiB, the budget the
JAX package checks against.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

__all__ = ["DecodeConfig", "kv_pool_bytes"]

_IMPLS = ("auto", "xla", "paged", "interpret")

_DEFAULT_HBM_BYTES = 16 * 1024**3


def kv_pool_bytes(pages: int, page_size: int, layers: int, hidden: int, dtype_bytes: int = 4) -> int:
    """Device bytes of a K+V page pool."""
    return 2 * pages * page_size * layers * hidden * dtype_bytes


def _parse_bytes(raw: str) -> int:
    """``"4G"`` / ``"512M"`` / ``"64K"`` / plain number -> bytes."""
    s = str(raw).strip()
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 1024, "m": 1024**2, "g": 1024**3}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult)


def default_hbm_bytes() -> int:
    """The pool budget: ``PATHWAY_HBM_BYTES`` when it parses, else 16 GiB."""
    raw = os.environ.get("PATHWAY_HBM_BYTES", "")
    if raw:
        try:
            return _parse_bytes(raw)
        except ValueError:
            pass
    return _DEFAULT_HBM_BYTES


@dataclass(frozen=True)
class DecodeConfig:
    """Validated decode-plane settings.

    ``pages``/``page_size`` size the paged-KV pool; ``lanes`` is the
    continuous-batching width (the step always runs at this width, so a
    sequence's tokens do not depend on its co-runners); ``max_new_tokens``
    caps generation per query and ``degrade_max_new_tokens`` is the clamp
    for a degraded query; ``max_seq`` bounds prompt + generation; ``impl``
    picks the attention path (``auto``: kernel B5 on a CUDA pool, its plain
    version on a CPU pool; ``paged``: the kernel, CUDA only; ``xla`` and
    ``interpret``: the plain version); ``hbm_bytes`` overrides the pool
    budget. ``prefix_cache``, ``spec_tokens``/``draft_*``,
    ``prefill_chunk`` and sampling (``temperature`` > 0, ``top_k``,
    ``top_p``, ``seed``) are validated as in the JAX package; the port's
    engine does not run them yet and raises when they are set."""

    pages: int = 256
    page_size: int = 16
    lanes: int = 8
    max_new_tokens: int = 64
    degrade_max_new_tokens: int = 16
    max_seq: int = 512
    rerank: bool = True
    impl: str = "auto"
    hbm_bytes: int | None = None
    prefix_cache: bool = False
    spec_tokens: int = 0
    draft_layers: int = 0
    draft_ngram: int = 0
    draft_weights: int = 0
    prefill_chunk: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.pages <= 0:
            raise ValueError("decode: pages must be positive")
        if self.page_size <= 0:
            raise ValueError("decode: page_size must be positive")
        if self.lanes <= 0:
            raise ValueError("decode: lanes must be positive")
        if self.max_new_tokens <= 0:
            raise ValueError("decode: max_new_tokens must be positive")
        if not 0 < self.degrade_max_new_tokens <= self.max_new_tokens:
            raise ValueError("decode: degrade_max_new_tokens must be in (0, max_new_tokens]")
        if self.max_seq < self.page_size:
            raise ValueError("decode: max_seq must cover at least one page")
        if self.impl not in _IMPLS:
            raise ValueError(f"decode: impl must be one of {_IMPLS}")
        if self.hbm_bytes is not None and self.hbm_bytes <= 0:
            raise ValueError("decode: hbm_bytes must be positive")
        for name in ("spec_tokens", "draft_layers", "draft_ngram", "draft_weights", "prefill_chunk"):
            if getattr(self, name) < 0:
                raise ValueError(f"decode: {name} must be >= 0")
        if self.temperature < 0:
            raise ValueError("decode: temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("decode: top_k must be >= 0")
        if not 0 < self.top_p <= 1:
            raise ValueError("decode: top_p must be in (0, 1]")
        if self.spec_tokens > 0 and self.temperature > 0:
            raise ValueError(
                "decode: speculative steps require greedy decode "
                "(temperature=0) — verification is exact argmax equality"
            )

    def as_dict(self) -> dict[str, Any]:
        return {f: getattr(self, f) for f in self.__dataclass_fields__}

    def pages_per_seq(self) -> int:
        """Static page-table width: pages covering ``max_seq``."""
        return (self.max_seq + self.page_size - 1) // self.page_size

    def pool_bytes(self, layers: int, hidden: int, dtype_bytes: int = 4) -> int:
        """K+V pool footprint for a decoder geometry."""
        return kv_pool_bytes(self.pages, self.page_size, layers, hidden, dtype_bytes)

    def check_budget(self, layers: int, hidden: int, dtype_bytes: int = 4) -> None:
        budget = self.hbm_bytes if self.hbm_bytes is not None else default_hbm_bytes()
        need = self.pool_bytes(layers, hidden, dtype_bytes)
        if need > budget:
            raise ValueError(
                f"decode: KV page pool needs {need} bytes "
                f"({self.pages} pages x {self.page_size} tokens x "
                f"{layers} layers x {hidden} hidden x 2 (K+V) x "
                f"{dtype_bytes} B) but the HBM budget is {budget} "
                f"(PATHWAY_HBM_BYTES / hbm_bytes=)"
            )
