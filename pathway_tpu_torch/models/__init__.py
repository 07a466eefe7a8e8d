"""Encoder models of the port: tokenizer, batching, TextEncoder, SentenceEncoder.

The same exports as the reference's ``models`` package. Its CLIP encoder
and contrastive trainer come with ROADMAP Queue A items 9 and 8.
"""

from .batching import bucket, chunks, pad_token_batch
from .encoder import CrossEncoderHead, EncoderConfig, TextEncoder, init_params
from .sentence_encoder import CrossEncoderScorer, SentenceEncoder
from .tokenizer import WordPieceTokenizer, default_tokenizer

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
]

_WAITING = {
    "CLIPEncoder": "ROADMAP Queue A item 9 (remaining models)",
    "CLIPConfig": "ROADMAP Queue A item 9 (remaining models)",
    "ContrastiveTrainer": "ROADMAP Queue A item 8 (training)",
    "info_nce_loss": "ROADMAP Queue A item 8 (training)",
}


def __getattr__(name):
    if name in _WAITING:
        raise AttributeError(f"pathway_tpu_torch.models.{name} comes with {_WAITING[name]}")
    raise AttributeError(name)
