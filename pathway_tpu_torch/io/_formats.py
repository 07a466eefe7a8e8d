"""Format settings for the file connectors.

The port's copy of the part of the reference's ``io/_formats.py`` that
the file connectors use (upstream Pathway's src/connectors/data_format.rs
DsvParser :500): ``CsvParserSettings`` and the dialect plumbing of every
CSV-reading connector. The parsers and formatters of the service-backed
connectors (JSON lines, Debezium, Postgres, BSON) come with those
connectors, ROADMAP Queue A item 1.
"""

from __future__ import annotations


class CsvParserSettings:
    """CSV dialect configuration (reference io/_utils.py:125 wrapping the
    engine-side parser options). Accepted by ``pw.io.csv.read`` /
    ``pw.io.s3_csv.read`` as ``csv_settings=`` and by :class:`DsvParser`.

    Args:
        delimiter: field separator.
        quote: quote character wrapping fields that contain the
            delimiter or newlines.
        escape: escape character inside quoted fields (None = rely on
            doubled quotes).
        enable_double_quote_escapes: treat ``""`` inside a quoted field
            as a literal quote.
        enable_quoting: honor the quote character at all; off = split
            on raw delimiters.
        comment_character: lines starting with this character are
            skipped entirely.
    """

    def __init__(
        self,
        delimiter: str = ",",
        quote: str = '"',
        escape: str | None = None,
        enable_double_quote_escapes: bool = True,
        enable_quoting: bool = True,
        comment_character: str | None = None,
    ):
        self.delimiter = delimiter
        self.quote = quote
        self.escape = escape
        self.enable_double_quote_escapes = enable_double_quote_escapes
        self.enable_quoting = enable_quoting
        self.comment_character = comment_character

    def reader_kwargs(self) -> dict:
        """Options for Python's csv module readers."""
        import csv as _pycsv

        return {
            "delimiter": self.delimiter,
            "quotechar": self.quote,
            "escapechar": self.escape,
            "doublequote": self.enable_double_quote_escapes,
            "quoting": _pycsv.QUOTE_MINIMAL if self.enable_quoting else _pycsv.QUOTE_NONE,
        }


def csv_reader_source(lines, csv_settings, raw_kwargs: dict):
    """Shared dialect plumbing for every CSV-reading connector (fs,
    s3/minio object store): returns ``(line_iterable, DictReader
    kwargs)`` honoring ``csv_settings`` — including quote-aware comment
    skipping — or the legacy raw ``delimiter``/``quotechar`` kwargs."""
    if csv_settings is None:
        return lines, {
            k: v for k, v in raw_kwargs.items() if k in ("delimiter", "quotechar")
        }
    dialect = csv_settings.reader_kwargs()
    comment_char = csv_settings.comment_character
    if not comment_char:
        return lines, dialect

    quote = csv_settings.quote
    escape = csv_settings.escape
    quoting = csv_settings.enable_quoting

    def skip_comments(src):
        # a comment line only counts OUTSIDE a quoted field — a
        # multi-line quoted value whose continuation happens to start
        # with the comment char is data. Under QUOTE_NONE the quote
        # char is literal data: no tracking at all.
        in_quote = False
        for ln in src:
            if not in_quote and ln.startswith(comment_char):
                continue
            if quoting:
                i, n = 0, len(ln)
                while i < n:
                    c = ln[i]
                    if escape and c == escape:
                        i += 2
                        continue
                    if c == quote:
                        in_quote = not in_quote
                    i += 1
            yield ln

    return skip_comments(lines), dialect
