"""Decode-plane configuration: ``pw.run(decode=)`` / ``PATHWAY_DECODE``.

Port of ``pathway_tpu/decode/config.py``: ``DecodeConfig`` with the same
fields, defaults and validation, plus ``pages_per_seq`` and the pool
sizing; the spec parser shared by the run keyword and the environment
variable; and the run-scoped active config that a ``DecodeEngine`` built
without a config picks up. Spec forms::

    pw.run(decode=True)                        # defaults
    pw.run(decode="pages=256,page=16,max_new=64")
    pw.run(decode={"pages": 256, "lanes": 8})
    PATHWAY_DECODE=auto | off | pages=512,page=32,cache=on,chunk=64

The pool budget is ``internals/ledger.default_hbm_bytes``:
``PATHWAY_HBM_BYTES`` when set, else the card's memory, else (without a
card) the reference's 16 GiB.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

from ..internals.ledger import default_hbm_bytes, kv_pool_bytes, parse_bytes

__all__ = ["DecodeConfig", "active_decode", "kv_pool_bytes", "parse_decode_spec", "set_active_decode", "use_decode"]

_IMPLS = ("auto", "xla", "paged", "interpret")

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
    budget.

    Serving extensions, all off by default (off runs the single-token
    whole-prefill scheduler): ``prefix_cache`` maps the cached full pages of
    a prompt's prefix instead of prefilling them; ``spec_tokens`` > 0 takes
    speculative steps, drafted by the first ``draft_layers`` target layers
    (0: half) or, with ``draft_ngram`` > 0, by prompt lookup, and verified
    in one batched forward (greedy only); ``draft_weights`` declares an
    external draft's bytes for budget math; ``prefill_chunk`` prefills at
    most that many prompt tokens a tick, interleaved with decode steps;
    ``temperature`` > 0 samples with ``top_k``/``top_p``, counter-based
    draws keyed on ``seed``, the prompt and the position."""

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


#: spec-key aliases accepted by :func:`parse_decode_spec`
_SPEC_KEYS = {
    "pages": "pages",
    "page": "page_size",
    "page_size": "page_size",
    "lanes": "lanes",
    "batch": "lanes",
    "max_new": "max_new_tokens",
    "max_new_tokens": "max_new_tokens",
    "degrade": "degrade_max_new_tokens",
    "degrade_max_new": "degrade_max_new_tokens",
    "degrade_max_new_tokens": "degrade_max_new_tokens",
    "max_seq": "max_seq",
    "rerank": "rerank",
    "impl": "impl",
    "hbm": "hbm_bytes",
    "hbm_bytes": "hbm_bytes",
    "cache": "prefix_cache",
    "prefix_cache": "prefix_cache",
    "spec": "spec_tokens",
    "spec_tokens": "spec_tokens",
    "draft": "draft_layers",
    "draft_layers": "draft_layers",
    "ngram": "draft_ngram",
    "draft_ngram": "draft_ngram",
    "draft_weights": "draft_weights",
    "chunk": "prefill_chunk",
    "prefill_chunk": "prefill_chunk",
    "temp": "temperature",
    "temperature": "temperature",
    "top_k": "top_k",
    "top_p": "top_p",
    "seed": "seed",
}

_BOOL_FIELDS = ("rerank", "prefix_cache")
_FLOAT_FIELDS = ("temperature", "top_p")
_BYTES_FIELDS = ("hbm_bytes", "draft_weights")

_OFF = ("off", "none", "0", "false", "no")
_ON = ("on", "true", "auto", "yes", "1", "")


def _coerce(kw: dict[str, Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, value in kw.items():
        if key not in _SPEC_KEYS:
            raise ValueError(f"decode: unknown spec key {key!r} (known: {sorted(set(_SPEC_KEYS))})")
        field = _SPEC_KEYS[key]
        if field in _BOOL_FIELDS:
            if isinstance(value, str):
                value = value.strip().lower() not in _OFF
            out[field] = bool(value)
        elif field == "impl":
            out[field] = str(value).strip().lower()
        elif field in _BYTES_FIELDS:
            out[field] = parse_bytes(value)
        elif field in _FLOAT_FIELDS:
            out[field] = float(value)
        else:
            out[field] = int(value)
    return out


def parse_decode_spec(spec: Any) -> DecodeConfig | None:
    """Any accepted decode spec as a config, or ``None`` (decode off).
    Raises ``ValueError`` on a malformed spec."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, DecodeConfig):
        return spec
    if spec is True:
        return DecodeConfig()
    if isinstance(spec, int):
        return None if spec == 0 else DecodeConfig(pages=spec)
    if isinstance(spec, dict):
        return DecodeConfig(**_coerce(spec))
    if isinstance(spec, str):
        text = spec.strip().lower()
        if text in _OFF:
            return None
        if text in _ON:
            return DecodeConfig()
        kw: dict[str, Any] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"decode: spec entries must be key=value, got {part!r}")
            key, _, value = part.partition("=")
            kw[key.strip().lower()] = value.strip()
        return DecodeConfig(**_coerce(kw))
    raise ValueError(f"decode: cannot parse spec of type {type(spec).__name__}")


# -- the run-scoped active config ---------------------------------------------

_decode_lock = threading.Lock()
_active_decode: DecodeConfig | None = None
_active_set = False
_env_cache: tuple[str, DecodeConfig | None] | None = None


def active_decode() -> DecodeConfig | None:
    """The decode config in effect: the run-installed one while a run has
    installed one, else ``PATHWAY_DECODE`` (parsed once per distinct value;
    a malformed value counts as off)."""
    global _env_cache
    with _decode_lock:
        if _active_set:
            return _active_decode
    raw = os.environ.get("PATHWAY_DECODE", "")
    if not raw.strip():
        return None
    with _decode_lock:
        if _env_cache is not None and _env_cache[0] == raw:
            return _env_cache[1]
    try:
        cfg = parse_decode_spec(raw)
    except ValueError:
        cfg = None
    with _decode_lock:
        _env_cache = (raw, cfg)
    return cfg


def set_active_decode(cfg: DecodeConfig | None) -> None:
    """Install (or clear, with ``None``) the run-scoped decode config.
    ``pw.run(decode=...)`` installs it around the run and clears it after,
    so the environment applies again between runs."""
    global _active_decode, _active_set
    with _decode_lock:
        _active_decode = cfg
        _active_set = cfg is not None


@contextmanager
def use_decode(spec: Any):
    """A decode config for the enclosed block (tests and embedded callers)."""
    global _active_decode, _active_set
    cfg = parse_decode_spec(spec)
    prev_cfg, prev_set = _active_decode, _active_set
    set_active_decode(cfg)
    try:
        yield cfg
    finally:
        with _decode_lock:
            _active_decode, _active_set = prev_cfg, prev_set
