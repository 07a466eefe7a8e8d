"""Chunking utilities.

The port's copy of the reference's ``xpacks/llm/splitters.py`` (upstream
Pathway's python/pathway/xpacks/llm/splitters.py: null_splitter :13,
TokenCountSplitter :34). Token counting uses the port's own wordpiece
tokenizer (``models/tokenizer.default_tokenizer``) instead of tiktoken,
so chunk boundaries line up with what the embedder consumes.
"""

from __future__ import annotations

import unicodedata

from ...internals import udfs
from ...internals.expression import ColumnExpression


def null_splitter(txt: str) -> list[tuple[str, dict]]:
    """No-op splitter: one chunk containing the whole text."""
    return [(txt, {})]


def _normalize_unicode(text: str) -> str:
    return unicodedata.normalize("NFKC", text)


_SENTENCE_ENDERS = ".!?\n"

_SENTENCE_RE = None
_WORD_RE = None


def _split_sentences(text: str) -> list[str]:
    import re

    global _SENTENCE_RE
    if _SENTENCE_RE is None:
        _SENTENCE_RE = re.compile(r"[^.!?\n]+[.!?\n]*")
    return [s.strip() for s in _SENTENCE_RE.findall(text) if s.strip()]


def _split_words(text: str) -> list[str]:
    import re

    global _WORD_RE
    if _WORD_RE is None:
        _WORD_RE = re.compile(r"\w+|[^\w\s]")
    return _WORD_RE.findall(text)


class TokenCountSplitter(udfs.UDF):
    """Split text into chunks of [min_tokens, max_tokens] tokens,
    preferring sentence boundaries (reference splitters.py:34).

    Returns list[(chunk_text, metadata_dict)].
    """

    def __init__(
        self,
        min_tokens: int = 50,
        max_tokens: int = 500,
        encoding_name: str = "cl100k_base",
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.min_tokens = min_tokens
        self.max_tokens = max_tokens
        self.encoding_name = encoding_name
        self._tokenizer = None

    def _count_tokens(self, text: str) -> int:
        if self._tokenizer is None:
            from ...models.tokenizer import default_tokenizer

            self._tokenizer = default_tokenizer()
        tok = self._tokenizer
        n = 0
        for word in _split_words(text.lower() if tok.lowercase else text):
            n += len(tok._word_ids(word))
        return n

    def chunk(self, txt: str) -> list[tuple[str, dict]]:
        """Pack sentences into chunks of [min_tokens, max_tokens] tokens;
        sentences longer than max_tokens are hard-split by words."""
        text = _normalize_unicode(txt)
        pieces: list[tuple[str, int]] = []
        for sentence in _split_sentences(text):
            n = self._count_tokens(sentence)
            if n <= self.max_tokens:
                pieces.append((sentence, n))
                continue
            words = sentence.split()
            cur: list[str] = []
            cur_n = 0
            for w in words:
                wn = self._count_tokens(w)
                if cur and cur_n + wn > self.max_tokens:
                    pieces.append((" ".join(cur), cur_n))
                    cur, cur_n = [], 0
                cur.append(w)
                cur_n += wn
            if cur:
                pieces.append((" ".join(cur), cur_n))

        out: list[tuple[str, dict]] = []
        buf: list[str] = []
        buf_n = 0
        for piece, n in pieces:
            if buf and buf_n + n > self.max_tokens:
                out.append((" ".join(buf).strip(), {}))
                buf, buf_n = [], 0
            buf.append(piece)
            buf_n += n
            if buf_n >= self.min_tokens and buf_n >= self.max_tokens // 2:
                # close the chunk early at a sentence boundary once past
                # the midpoint so chunks stay balanced
                if buf_n >= self.max_tokens:
                    out.append((" ".join(buf).strip(), {}))
                    buf, buf_n = [], 0
        if buf:
            out.append((" ".join(buf).strip(), {}))
        return [c for c in out if c[0]]

    def __wrapped__(self, txt: str, **kwargs) -> list[tuple[str, dict]]:
        return self.chunk(txt)

    def __call__(self, text: ColumnExpression, **kwargs) -> ColumnExpression:
        return super().__call__(text, **kwargs)
