"""Shared parsers and formatters for the IO connectors.

The port's copy of the reference's ``io/_formats.py``, the format layer of
upstream Pathway (src/connectors/data_format.rs): the Dsv / JsonLines /
Identity parsers (:500, :1439, :831), the Debezium change-event parser
(:1053), and the Dsv / JsonLines / SingleColumn / PsqlUpdates /
PsqlSnapshot / Bson formatters (:938, :1822, :1011, :1625, :1684, :1975),
with ``CsvParserSettings`` and the dialect plumbing of every CSV-reading
connector. Connectors compose these with the reader / writer runtime in
``_connector.py``.
"""

from __future__ import annotations

import datetime as _dt
import json
from typing import Any, Callable, Iterable

import numpy as np

from ..engine.value import Json, Pointer

# ---------------------------------------------------------------------------
# value serialization (shared by JSON-ish formatters; matches the
# reference's serialize_value_to_json, data_format.rs:1105)
# ---------------------------------------------------------------------------


def jsonable_value(v: Any) -> Any:
    if isinstance(v, Json):
        return v.value
    if isinstance(v, Pointer):
        return repr(v)
    if isinstance(v, bytes):
        return list(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (tuple, list)):
        return [jsonable_value(x) for x in v]
    if isinstance(v, dict):
        return {k: jsonable_value(x) for k, x in v.items()}
    if isinstance(v, _dt.datetime):
        return v.isoformat(sep=" ")
    if isinstance(v, _dt.timedelta):
        return int(v.total_seconds() * 1e9)  # nanoseconds, like Duration
    return v


# ---------------------------------------------------------------------------
# parsers: bytes/str payload -> list of (op, values_dict) change events
# op: "insert" | "delete" | "upsert"
# ---------------------------------------------------------------------------


class JsonLinesParser:
    """One JSON object per message (data_format.rs JsonLinesParser :1439)."""

    def __init__(self, field_names: list[str] | None = None):
        self.field_names = field_names

    def parse(self, payload: bytes | str) -> list[tuple[str, dict]]:
        if isinstance(payload, bytes):
            payload = payload.decode()
        rec = json.loads(payload)
        if not isinstance(rec, dict):
            raise ValueError(f"expected a JSON object, got {type(rec).__name__}")
        if self.field_names is not None:
            rec = {k: rec.get(k) for k in self.field_names}
        return [("insert", rec)]


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


class DsvParser:
    """Delimiter-separated values with a header (data_format.rs :500).
    Quote/escape/comment handling comes from ``settings``; the plain
    ``separator`` shorthand keeps the naive fast path."""

    def __init__(
        self,
        field_names: list[str] | None = None,
        separator: str = ",",
        settings: CsvParserSettings | None = None,
    ):
        self.field_names = field_names
        self.settings = settings
        self.separator = settings.delimiter if settings is not None else separator
        self._header: list[str] | None = list(field_names) if field_names else None
        self._expects_header = field_names is None

    def _split(self, line: str) -> list[str]:
        if self.settings is None:
            return line.split(self.separator)
        import csv as _pycsv

        return next(_pycsv.reader([line], **self.settings.reader_kwargs()))

    def parse(self, payload: bytes | str) -> list[tuple[str, dict]]:
        if isinstance(payload, bytes):
            payload = payload.decode()
        line = payload.rstrip("\r\n")
        if (
            self.settings is not None
            and self.settings.comment_character
            and line.startswith(self.settings.comment_character)
        ):
            return []
        parts = self._split(line)
        if self._expects_header and self._header is None:
            self._header = parts
            return []
        assert self._header is not None
        if len(parts) != len(self._header):
            raise ValueError(
                f"row has {len(parts)} fields, header has {len(self._header)}"
            )
        return [("insert", dict(zip(self._header, parts)))]


class IdentityParser:
    """Whole payload into one column (data_format.rs IdentityParser :831)."""

    def __init__(self, column: str = "data", as_bytes: bool = True):
        self.column = column
        self.as_bytes = as_bytes

    def parse(self, payload: bytes | str) -> list[tuple[str, dict]]:
        if self.as_bytes and isinstance(payload, str):
            payload = payload.encode()
        if not self.as_bytes and isinstance(payload, bytes):
            payload = payload.decode()
        return [("insert", {self.column: payload})]


class DebeziumMessageParser:
    """Debezium change events (data_format.rs DebeziumMessageParser :1053).

    ``parse(key_payload, value_payload)`` handles the envelope's
    ``payload.op``: "r"/"c" → insert of ``payload.after``; "u" → delete
    of ``payload.before`` + insert of ``payload.after`` (postgres) or a
    keyed upsert (mongodb, which omits ``before``); "d" → delete.
    A null value payload is a Kafka tombstone → no events.
    """

    def __init__(self, value_field_names: list[str] | None = None, db_type: str = "postgres"):
        self.value_field_names = value_field_names
        assert db_type in ("postgres", "mongodb")
        self.db_type = db_type

    @property
    def session_type(self) -> str:
        # MongoDB events lack the previous state → upsert session
        # (data_format.rs :1431-1434)
        return "upsert" if self.db_type == "mongodb" else "native"

    def _values(self, payload: Any) -> dict:
        if self.db_type == "mongodb" and isinstance(payload, str):
            # in Mongo's envelope `after` is a JSON *string*
            payload = json.loads(payload)
        if not isinstance(payload, dict):
            raise ValueError("debezium record payload is not an object")
        if self.value_field_names is not None:
            return {k: payload.get(k) for k in self.value_field_names}
        return dict(payload)

    def parse(
        self, key_payload: bytes | str | None, value_payload: bytes | str | None
    ) -> list[tuple[str, dict | None, Any]]:
        """-> list of (op, values|None, key_values) events."""
        if value_payload is None:
            return []  # tombstone
        if isinstance(value_payload, bytes):
            value_payload = value_payload.decode()
        change = json.loads(value_payload)
        if change is None:
            return []  # tombstone
        if not isinstance(change, dict) or "payload" not in change:
            raise ValueError("debezium message has no payload")
        payload = change["payload"]
        key_values = None
        if key_payload:
            if isinstance(key_payload, bytes):
                key_payload = key_payload.decode()
            key_change = json.loads(key_payload)
            if isinstance(key_change, dict):
                key_values = key_change.get("payload", key_change)
        op = payload.get("op")
        if op in ("r", "c"):
            return [("insert", self._values(payload["after"]), key_values)]
        if op == "u":
            if self.db_type == "mongodb":
                return [("upsert", self._values(payload["after"]), key_values)]
            return [
                ("delete", self._values(payload["before"]), key_values),
                ("insert", self._values(payload["after"]), key_values),
            ]
        if op == "d":
            if self.db_type == "mongodb":
                return [("upsert", None, key_values)]
            return [("delete", self._values(payload["before"]), key_values)]
        raise ValueError(f"unknown debezium op {op!r}")


# ---------------------------------------------------------------------------
# formatters: (row_dict, time, diff) -> payload(s) for a sink
# ---------------------------------------------------------------------------


class JsonLinesFormatter:
    """(data_format.rs JsonLinesFormatter :1822)"""

    def __init__(self, field_names: list[str]):
        self.field_names = field_names

    def format(self, row: dict, time: int, diff: int) -> str:
        rec = {n: jsonable_value(row[n]) for n in self.field_names}
        rec["time"] = time
        rec["diff"] = diff
        return json.dumps(rec)


class DsvFormatter:
    """(data_format.rs DsvFormatter :938)"""

    def __init__(self, field_names: list[str], separator: str = ","):
        self.field_names = field_names
        self.separator = separator

    def header(self) -> str:
        return self.separator.join(self.field_names + ["time", "diff"])

    def format(self, row: dict, time: int, diff: int) -> str:
        return self.separator.join(
            [str(row[n]) for n in self.field_names] + [str(time), str(diff)]
        )


class SingleColumnFormatter:
    """(data_format.rs SingleColumnFormatter :1011)"""

    def __init__(self, field_name: str):
        self.field_name = field_name

    def format(self, row: dict, time: int, diff: int):
        return row[self.field_name]


class PsqlUpdatesFormatter:
    """Append-only stream of updates with time/diff columns
    (data_format.rs PsqlUpdatesFormatter :1625)."""

    def __init__(self, table_name: str, field_names: list[str]):
        self.table_name = table_name
        self.field_names = field_names

    def format(self, row: dict, time: int, diff: int) -> tuple[str, tuple]:
        cols = ",".join(self.field_names)
        placeholders = ",".join(f"%s" for _ in self.field_names)
        sql = (
            f"INSERT INTO {self.table_name} ({cols},time,diff) "
            f"VALUES ({placeholders},{int(time)},{int(diff)})"
        )
        return sql, tuple(row[n] for n in self.field_names)


class PsqlSnapshotFormatter:
    """Maintained snapshot keyed by ``primary_key`` (data_format.rs
    PsqlSnapshotFormatter :1684): inserts upsert on conflict, guarded so
    an older time never overwrites a newer row; deletions remove the
    keyed row."""

    def __init__(self, table_name: str, primary_key: list[str], field_names: list[str]):
        unknown = [k for k in primary_key if k not in field_names]
        if unknown:
            raise ValueError(f"unknown key fields: {unknown}")
        self.table_name = table_name
        self.primary_key = primary_key
        self.field_names = field_names
        self.value_fields = [n for n in field_names if n not in primary_key]

    def format(self, row: dict, time: int, diff: int) -> tuple[str, tuple]:
        t, d = int(time), int(diff)
        if diff == 1:
            cols = ",".join(self.field_names)
            placeholders = ",".join("%s" for _ in self.field_names)
            updates = ",".join(
                f"{n}=EXCLUDED.{n}" for n in self.value_fields + []
            )
            conflict = ",".join(self.primary_key)
            sql = (
                f"INSERT INTO {self.table_name} ({cols},time,diff) "
                f"VALUES ({placeholders},{t},{d}) "
                f"ON CONFLICT ({conflict}) DO UPDATE SET "
                f"{updates + ',' if updates else ''}time={t},diff={d} "
                f"WHERE {self.table_name}.time<={t}"
            )
            return sql, tuple(row[n] for n in self.field_names)
        cond = " AND ".join(f"{k}=%s" for k in self.primary_key)
        sql = f"DELETE FROM {self.table_name} WHERE {cond} AND time<={t}"
        return sql, tuple(row[k] for k in self.primary_key)


class BsonFormatter:
    """Document per change with time/diff fields (data_format.rs
    BsonFormatter :1975) — emits plain dicts; the Mongo client encodes."""

    def __init__(self, field_names: list[str]):
        self.field_names = field_names

    def format(self, row: dict, time: int, diff: int) -> dict:
        doc = {n: jsonable_value(row[n]) for n in self.field_names}
        doc["time"] = int(time)
        doc["diff"] = int(diff)
        return doc


class NullFormatter:
    def __init__(self, field_names: list[str] | None = None):
        self.field_names = field_names or []

    def format(self, row: dict, time: int, diff: int) -> None:
        return None
