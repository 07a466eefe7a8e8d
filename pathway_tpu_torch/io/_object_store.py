"""Generic object-store scanner shared by the bucket-style connectors
(s3, minio, s3_csv, gdrive, pyfilesystem).

The port's copy of the reference's ``io/_object_store.py`` (upstream
Pathway's POSIX-like scanner, src/connectors/posix_like.rs:279 with the
scanner/{filesystem,s3}.rs backends): a connector provides an
``ObjectStoreClient`` (list + fetch with version stamps) and the shared
loop turns objects into keyed row upserts, exactly like the local fs
scanner — streaming mode re-lists and upserts changed/deleted objects,
offsets persist {key: (version, n_rows)} so recovery skips unchanged
objects. A streaming scan ends with its run (or after one scan under
``PATHWAY_TPU_FS_ONESHOT``).
"""

from __future__ import annotations

import csv as _csv
import io as _io
import json
import os
from typing import Any, Iterable, Protocol

from ..engine.value import Json
from ..internals import dtype as dt
from ..internals.schema import ColumnDefinition, Schema, schema_builder
from ..internals.table import Table
from ._connector import (
    StreamingContext,
    input_table_from_reader,
    static_table_from_rows,
)

_POLL_INTERVAL_S = 1.0


class ObjectStoreClient(Protocol):
    def list_objects(self) -> Iterable[tuple[str, Any]]:
        """-> (key, version) pairs; version changes when content does."""

    def get_object(self, key: str) -> bytes:
        """-> the object's raw bytes."""


class ObjectCache:
    """Disk-backed object cache keyed by (key, version) — upstream
    Pathway's CachedObjectStorage
    (src/persistence/cached_object_storage.rs:1-377):
    fetched objects persist across restarts and re-scans, so an
    unchanged object is never downloaded twice. Layout: one
    ``<blake2b(key)>.bin`` blob + ``.meta`` JSON ({key, version}) per
    object under ``root``."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _paths(self, key: str) -> tuple[str, str]:
        import hashlib

        h = hashlib.blake2b(key.encode(), digest_size=16).hexdigest()
        return os.path.join(self.root, h + ".bin"), os.path.join(self.root, h + ".meta")

    def get(self, key: str, version: Any) -> bytes | None:
        blob, meta = self._paths(key)
        try:
            with open(meta) as f:
                m = json.load(f)
            if m.get("key") != key or m.get("version") != _jsonable(version):
                return None
            with open(blob, "rb") as f:
                return f.read()
        except (OSError, ValueError):
            return None

    def put(self, key: str, version: Any, payload: bytes) -> None:
        blob, meta = self._paths(key)
        # invalidate meta FIRST: a crash between the blob replace and
        # the meta write must leave a cache miss, never an old meta
        # pointing at new bytes (served as the old version if the
        # object later reverts)
        try:
            os.remove(meta)
        except OSError:
            pass
        import tempfile

        # unique tmp names: concurrent writers sharing a cache dir must
        # never truncate each other's in-flight blob
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.replace(tmp, blob)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        fdm, tmpm = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fdm, "w") as f:
                json.dump({"key": key, "version": _jsonable(version)}, f)
            os.replace(tmpm, meta)
        except BaseException:
            try:
                os.unlink(tmpm)
            except OSError:
                pass
            raise

    def drop(self, key: str) -> None:
        for p in self._paths(key):
            try:
                os.remove(p)
            except OSError:
                pass


def _jsonable(version: Any):
    # round-trip so compare sees what a reload sees (tuples -> lists)
    try:
        return json.loads(json.dumps(version))
    except (TypeError, ValueError):
        return repr(version)


def rows_from_payload(
    payload: bytes,
    format: str,
    with_metadata: bool,
    metadata: dict | None,
    **kwargs,
) -> list[dict]:
    """Decode one object's payload into dict rows (same format
    vocabulary as pw.io.fs)."""
    rows: list[dict] = []
    if format == "binary":
        rows.append({"data": payload})
    elif format in ("plaintext", "plaintext_by_file"):
        text = payload.decode(errors="replace")
        if format == "plaintext_by_file":
            rows.append({"data": text.rstrip("\n")})
        else:
            rows.extend(
                {"data": line} for line in text.splitlines() if line
            )
    elif format == "csv":
        from ._formats import csv_reader_source

        src, dialect = csv_reader_source(
            _io.StringIO(payload.decode(errors="replace")),
            kwargs.get("csv_settings"),
            kwargs,
        )
        reader = _csv.DictReader(src, **dialect)
        rows.extend(dict(rec) for rec in reader)
    elif format in ("json", "jsonlines"):
        for line in payload.decode(errors="replace").splitlines():
            line = line.strip()
            if line:
                rows.append(dict(json.loads(line)))
    else:
        raise ValueError(f"unsupported format {format!r}")
    if with_metadata:
        meta = Json(metadata or {})
        for r in rows:
            r["_metadata"] = meta
    return rows


def default_schema(format: str, with_metadata: bool) -> type[Schema]:
    col = dt.BYTES if format == "binary" else dt.STR
    cols: dict[str, Any] = {"data": ColumnDefinition(dtype=col)}
    if with_metadata:
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
    return schema_builder(cols, name="ObjectStoreSchema")


def read_object_store(
    client_factory,
    *,
    format: str,
    schema: type[Schema] | None,
    mode: str,
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str = "object_store",
    persistent_id: str | None = None,
    poll_interval_s: float = _POLL_INTERVAL_S,
    object_cache: str | ObjectCache | None = None,
    object_size_limit: int | None = None,
    retry_policy: Any = None,
    **kwargs,
) -> Table:
    """Build an input table over an ObjectStoreClient.

    ``client_factory()`` is called on the reader thread (so slow client
    construction/auth never blocks graph building).

    ``object_cache``: directory (or ObjectCache) persisting fetched
    objects by version — restarts and re-scans skip downloads of
    unchanged objects entirely (upstream cached_object_storage.rs).

    ``object_size_limit``: oversized objects yield an empty payload.
    Enforced on EVERY serve path (fresh fetch AND cache hit — a cached
    full payload must not bypass a later limit), the cache only ever
    stores real content, and skipped objects record a limit-tagged
    version so changing the limit re-evaluates them."""
    cache = ObjectCache(object_cache) if isinstance(object_cache, str) else object_cache

    def fetch(client, key: str, version: Any) -> tuple[bytes, bool]:
        """-> (payload, skipped_by_limit)."""
        if object_size_limit is not None:
            # listing-provided size metadata skips the download entirely
            size = getattr(client, "sizes", {}).get(key)
            if size is not None and size > object_size_limit:
                import logging

                logging.info(
                    "object store: skipping %s (size %d > limit %d)",
                    key,
                    size,
                    object_size_limit,
                )
                return b"", True
        payload = None
        if cache is not None:
            payload = cache.get(key, version)
        if payload is None:
            payload = client.get_object(key)
            if cache is not None:
                cache.put(key, version, payload)
        if object_size_limit is not None and len(payload) > object_size_limit:
            return b"", True
        return payload, False

    def effective_version(version: Any, skipped: bool) -> Any:
        # with a limit configured, EVERY recorded version carries the
        # limit it was evaluated under: changing the limit (adding,
        # raising, lowering) re-evaluates each object — a plain version
        # match could serve stale full/empty payloads otherwise
        if object_size_limit is None:
            return version
        tag = "__oversized__" if skipped else "__ok__"
        return [tag, _jsonable(version), object_size_limit]

    if schema is None:
        schema = default_schema(format, with_metadata)
    elif with_metadata and "_metadata" not in schema.column_names():
        cols = dict(schema.columns())
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
        schema = schema_builder(cols, name=schema.__name__)

    if mode == "static":
        client = client_factory()
        rows: list[dict] = []
        for key, version in sorted(client.list_objects()):
            payload, _skipped = fetch(client, key, version)
            rows.extend(
                rows_from_payload(
                    payload, format, with_metadata, {"path": key}, **kwargs
                )
            )
        return static_table_from_rows(schema, rows, name=name)

    def reader(ctx: StreamingContext) -> None:
        client = client_factory()
        known: dict[str, tuple[Any, int]] = {
            k: tuple(v)
            for k, v in ctx.offsets.items()
            if isinstance(k, str) and k != "__seq__"
        }
        while True:
            current: dict[str, Any] = dict(client.list_objects())
            changed = False
            for key in sorted(current):
                version = current[key]
                old = known.get(key)
                # unchanged iff the recorded version matches either the
                # plain content version (served fully before) or the
                # skip marker for the SAME limit (skipped before; a
                # changed limit must re-evaluate)
                unchanged = False
                if old is not None:
                    if isinstance(old[0], (list, tuple)):
                        unchanged = list(old[0]) in (
                            effective_version(version, True),
                            effective_version(version, False),
                        )
                    else:
                        unchanged = (
                            object_size_limit is None and old[0] == version
                        )
                if unchanged:
                    continue
                old_n = old[1] if old is not None else 0
                payload, skipped = fetch(client, key, version)
                rows = rows_from_payload(
                    payload, format, with_metadata, {"path": key}, **kwargs
                )
                for i, row in enumerate(rows):
                    ctx.upsert_keyed((key, i), row)
                for i in range(len(rows), old_n):
                    ctx.upsert_keyed((key, i), None)
                known[key] = (effective_version(version, skipped), len(rows))
                ctx.set_offset(key, known[key])
                changed = True
            for key in list(known):
                if key not in current:
                    _v, old_n = known.pop(key)
                    for i in range(old_n):
                        ctx.upsert_keyed((key, i), None)
                    ctx.set_offset(key, None)
                    if cache is not None:
                        cache.drop(key)
                    changed = True
            if changed:
                ctx.commit()
            if _oneshot() or ctx.wait_stopped(poll_interval_s):
                return

    return input_table_from_reader(
        schema,
        reader,
        name=name,
        autocommit_duration_ms=autocommit_duration_ms,
        persistent_id=persistent_id,
        supports_offsets=True,  # resumes from {key: (version, n_rows)}
        retry_policy=retry_policy,
    )


def _oneshot() -> bool:
    return bool(os.environ.get("PATHWAY_TPU_FS_ONESHOT"))
