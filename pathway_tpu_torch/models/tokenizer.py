"""WordPiece tokenizer (host-side).

The port's own copy of ``pathway_tpu/models/tokenizer.py``: a standard
BERT ``vocab.txt`` when one is available locally, else deterministic
hashing of whitespace/punctuation tokens into the vocab id space. Ids
are identical to the reference's ``encode``. ``batch_encode_matrix``
runs ASCII rows through the C++ batched tokenizer
(``pathway_tpu_torch/native.py``, ``pn_tok_encode_batch``, the same ids
as ``encode``); other rows, and every row under
``PATHWAY_DISABLE_NATIVE=1``, take the Python ``encode``.
"""

from __future__ import annotations

import os
import re
import zlib

import numpy as np

_BASIC = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")

CLS, SEP, PAD, UNK, MASK = 101, 102, 0, 100, 103


class WordPieceTokenizer:
    def __init__(
        self,
        vocab_file: str | None = None,
        vocab_size: int = 30522,
        lowercase: bool = True,
        max_input_chars_per_word: int = 100,
    ):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.max_chars = max_input_chars_per_word
        self.vocab: dict[str, int] | None = None
        self._native = None  # NativeTokenizer, made at the first batch
        self._vocab_file = vocab_file if vocab_file and os.path.exists(vocab_file) else None
        if self._vocab_file:
            with open(self._vocab_file, encoding="utf-8") as f:
                self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.cls_id, self.sep_id, self.pad_id, self.unk_id = CLS, SEP, PAD, UNK
        if self.vocab is not None:
            self.cls_id = self.vocab.get("[CLS]", CLS)
            self.sep_id = self.vocab.get("[SEP]", SEP)
            self.pad_id = self.vocab.get("[PAD]", PAD)
            self.unk_id = self.vocab.get("[UNK]", UNK)

    def _word_ids(self, word: str) -> list[int]:
        if self.vocab is None:
            # stable hash into the non-special id range
            return [999 + zlib.crc32(word.encode()) % (self.vocab_size - 1000)]
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_len: int = 128) -> list[int]:
        if self.lowercase:
            text = text.lower()
        ids = [self.cls_id]
        for word in _BASIC.findall(text):
            ids.extend(self._word_ids(word))
            if len(ids) >= max_len - 1:
                break
        ids = ids[: max_len - 1]
        ids.append(self.sep_id)
        return ids

    def batch_encode_matrix(self, texts, max_len: int = 128, stage=None):
        """-> (ids [n, max_len] int32, lens [n] int32). Rows are
        pad_id-filled past their length, ready for the encoder's
        bucketed batching. ASCII rows go through the native batched
        tokenizer (its scanner is ASCII-only); the others, and all rows
        when native is disabled, through the Python ``encode``.

        ``stage``: an optional ``ingest.HostIngestStage``; the ASCII rows
        are then encoded as shard calls on its workers
        (``pn_tok_encode_shard`` releases the GIL), each writing a disjoint
        row range of the shared matrices: the same values at any worker
        count."""
        from .. import native

        texts = list(texts)
        n = len(texts)
        native_rows = [i for i, t in enumerate(texts) if t.isascii()] if native.is_available() else []
        if native_rows and self._native is None:
            self._native = native.NativeTokenizer(self._vocab_file, self.vocab_size, self.lowercase, self.max_chars)

        def encode_native(rows):
            if stage is not None and len(rows) >= 2:
                return self._encode_matrix_staged(rows, max_len, stage)
            return self._native.encode_batch(rows, max_len)

        if len(native_rows) == n and n:
            return encode_native(texts)
        ids = np.full((n, max_len), self.pad_id, np.int32)
        lens = np.zeros(n, np.int32)
        if native_rows:
            ids[native_rows], lens[native_rows] = encode_native([texts[i] for i in native_rows])
        for i in sorted(set(range(n)) - set(native_rows)):
            row = self.encode(texts[i], max_len=max_len)
            ids[i, : len(row)] = row
            lens[i] = len(row)
        return ids, lens

    def _encode_matrix_staged(self, texts, max_len: int, stage):
        """ASCII rows sharded over the ingest stage's workers into one
        shared output: each shard call covers a disjoint row range, so the
        rows are what one ``encode_batch`` call gives."""
        n = len(texts)
        blob, offsets = self._native.prepare_blob(texts)
        out_ids = np.empty((n, max_len), np.int32)
        out_lens = np.empty(n, np.int32)
        shard = max(64, -(-n // max(1, stage.workers * 2)))
        spans = [(b, min(b + shard, n)) for b in range(0, n, shard)]

        def run(span):
            self._native.encode_shard(blob, offsets, span[0], span[1], max_len, out_ids, out_lens)

        for _ in stage.map_ordered(run, spans):
            pass
        return out_ids, out_lens

    def encode_pair(self, a: str, b: str, max_len: int = 256) -> tuple[list[int], list[int]]:
        """(ids, token_type_ids) for cross-encoder input [CLS] a [SEP] b [SEP]."""
        if self.lowercase:
            a, b = a.lower(), b.lower()
        ia: list[int] = []
        for w in _BASIC.findall(a):
            ia.extend(self._word_ids(w))
        ib: list[int] = []
        for w in _BASIC.findall(b):
            ib.extend(self._word_ids(w))
        # truncate the longer side first (HF longest_first strategy)
        budget = max_len - 3
        while len(ia) + len(ib) > budget:
            if len(ia) >= len(ib):
                ia.pop()
            else:
                ib.pop()
        ids = [self.cls_id] + ia + [self.sep_id] + ib + [self.sep_id]
        tt = [0] * (len(ia) + 2) + [1] * (len(ib) + 1)
        return ids, tt


def default_tokenizer(model_dir: str | None = None) -> WordPieceTokenizer:
    candidates = []
    if model_dir:
        candidates.append(os.path.join(model_dir, "vocab.txt"))
    env = os.environ.get("PATHWAY_TPU_VOCAB")
    if env:
        candidates.append(env)
    for c in candidates:
        if os.path.exists(c):
            return WordPieceTokenizer(vocab_file=c)
    return WordPieceTokenizer()
