"""The decode plane of the port: decoder model math, the paged-KV
continuous-batching ``DecodeEngine`` with its serving extensions (prefix
cache, chunked prefill, speculative and sampled decode), the
``DecodeService`` front door on the ``AdaptiveBatcher``, ``DecodeConfig``
with its spec parser and run-scoped config (``pw.run(decode=)`` /
``PATHWAY_DECODE``), the decode metrics and the prefix cache."""

from .config import DecodeConfig, active_decode, parse_decode_spec, set_active_decode, use_decode
from .engine import (
    DecodeEngine,
    DecoderConfig,
    DecodeService,
    DecodeTicket,
    decode_greedy,
    init_decoder_params,
)
from .metrics import DECODE_METRICS, DecodeMetrics
from .prefix_cache import PrefixCache

__all__ = [
    "DECODE_METRICS",
    "DecodeConfig",
    "DecodeEngine",
    "DecodeMetrics",
    "DecodeService",
    "DecodeTicket",
    "DecoderConfig",
    "PrefixCache",
    "active_decode",
    "decode_greedy",
    "init_decoder_params",
    "parse_decode_spec",
    "set_active_decode",
    "use_decode",
]
