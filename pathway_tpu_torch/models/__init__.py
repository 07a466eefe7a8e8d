"""Encoder models of the port: tokenizer, batching, TextEncoder,
SentenceEncoder and the contrastive trainer.

The same exports as the reference's ``models`` package. Its CLIP encoder
comes with ROADMAP Queue A item 9.
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
]

_WAITING = {
    "CLIPEncoder": "ROADMAP Queue A item 9 (remaining models)",
    "CLIPConfig": "ROADMAP Queue A item 9 (remaining models)",
}


def __getattr__(name):
    if name in _WAITING:
        raise AttributeError(f"pathway_tpu_torch.models.{name} comes with {_WAITING[name]}")
    raise AttributeError(name)
