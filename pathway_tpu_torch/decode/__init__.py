"""The decode plane of the port: decoder model math, the paged-KV
continuous-batching ``DecodeEngine`` and its ``DecodeConfig``."""

from .config import DecodeConfig
from .engine import DecodeEngine, DecoderConfig, DecodeTicket, decode_greedy, init_decoder_params

__all__ = ["DecodeConfig", "DecodeEngine", "DecodeTicket", "DecoderConfig", "decode_greedy", "init_decoder_params"]
