"""Encoder models of the port: tokenizer, batching, TextEncoder,
SentenceEncoder, the contrastive trainer and CLIP.

The same exports as the reference's ``models`` package; ``CLIPEncoder``
and ``CLIPConfig`` resolve lazily, as the reference's do.
"""

from .batching import bucket, chunks, pad_token_batch
from .encoder import CrossEncoderHead, EncoderConfig, TextEncoder, init_params
from .sentence_encoder import CrossEncoderScorer, SentenceEncoder
from .tokenizer import WordPieceTokenizer, default_tokenizer
from .training import ContrastiveTrainer, info_nce_loss

__all__ = [
    "EncoderConfig",
    "TextEncoder",
    "CrossEncoderHead",
    "init_params",
    "SentenceEncoder",
    "CrossEncoderScorer",
    "WordPieceTokenizer",
    "default_tokenizer",
    "pad_token_batch",
    "bucket",
    "chunks",
    "ContrastiveTrainer",
    "info_nce_loss",
    "CLIPEncoder",
    "CLIPConfig",
]


def __getattr__(name):  # lazy, as the reference's
    if name in ("CLIPEncoder", "CLIPConfig"):
        from . import clip

        return getattr(clip, name)
    raise AttributeError(name)
