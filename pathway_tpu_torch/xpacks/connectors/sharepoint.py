"""SharePoint connector (enterprise xpack).

The port's copy of the reference's ``xpacks/connectors/sharepoint.py``
(upstream Pathway's python/pathway/xpacks/connectors/sharepoint/__init__.py
:29-376): a SharePoint document-library folder is polled like an object store —
each scan diffs file metadata (path, size, created/modified stamps)
against the previous snapshot, re-downloads changed files, retracts
deleted ones, and skips the payload (empty bytes + a status marker in
``_metadata``) for files over ``object_size_limit``.  ``static`` mode
ingests one snapshot and stops; ``streaming`` re-scans every
``refresh_interval`` seconds with bounded retry on scan failures.

The Office365 client is injectable (``_context_factory``) so the
scanner/diff/size-limit/retry logic unit-tests without credentials or
the ``office365`` package, matching the injectable-client pattern of
the other connectors (e.g. ``io/gdrive.py``). A streaming read, and a
wait between retries, end with the run.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Iterable, Protocol
from urllib.parse import quote, urlparse

from ...engine.value import Json
from ...internals import dtype as dt
from ...internals.config import get_pathway_config, pathway_config
from ...internals.licensing import License
from ...internals.schema import ColumnDefinition, Schema, schema_builder
from ...internals.table import Table
from ...io._connector import StreamingContext, input_table_from_reader

STATUS_DOWNLOADED = "downloaded"
STATUS_SIZE_LIMIT_EXCEEDED = "size_limit_exceeded"


class SharePointFile(Protocol):
    """One file of a scan: metadata properties + content fetch."""

    #: server-relative path, e.g. "/sites/Site/Shared Documents/a.pdf"
    path: str
    size: int
    created_at: int  # UNIX seconds
    modified_at: int  # UNIX seconds

    def read(self) -> bytes: ...


class SharePointContext(Protocol):
    """The injectable client: lists the files under a folder."""

    def list_files(self, root_path: str, recursive: bool) -> Iterable[SharePointFile]: ...


class _Office365File:
    """Adapter from an office365 ``File`` to SharePointFile."""

    def __init__(self, entry):
        self._entry = entry
        self.path = entry.properties["ServerRelativeUrl"]
        self.size = int(entry.length)
        self.created_at = int(entry.time_created.timestamp())
        self.modified_at = int(entry.time_last_modified.timestamp())

    def read(self) -> bytes:
        return self._entry.get_content().execute_query().value


class _Office365Context:
    """Real client over office365-rest-python-client, authenticated with
    an app certificate (reference sharepoint/__init__.py:232-251)."""

    def __init__(self, url, tenant, client_id, thumbprint, cert_path):
        try:
            from office365.sharepoint.client_context import ClientContext  # type: ignore
        except ImportError as e:  # pragma: no cover - needs office365
            raise ImportError(
                "pw.xpacks.connectors.sharepoint requires the "
                "'Office365-REST-Python-Client' package"
            ) from e
        self._context = ClientContext(url).with_client_certificate(
            tenant=tenant,
            client_id=client_id,
            thumbprint=thumbprint,
            cert_path=cert_path,
        )
        web = self._context.web
        self._context.load(web)
        self._context.execute_query()

    def list_files(self, root_path: str, recursive: bool):
        folder = self._context.web.get_folder_by_server_relative_path(root_path)
        files = folder.get_files(recursive).execute_query()
        return [_Office365File(f) for f in files]


class _EntryMeta:
    """Snapshot metadata for one file (reference _SharePointEntryMeta
    sharepoint/__init__.py:29-75)."""

    __slots__ = ("created_at", "modified_at", "path", "size", "seen_at", "status", "base_url")

    def __init__(self, file: SharePointFile, base_url: str | None = None):
        self.created_at = file.created_at
        self.modified_at = file.modified_at
        self.path = file.path
        self.size = file.size
        self.seen_at = int(time.time())
        self.status = STATUS_DOWNLOADED
        self.base_url = base_url

    @classmethod
    def from_parts(cls, path: str, created_at: int, modified_at: int, size: int) -> "_EntryMeta":
        """Rebuild snapshot metadata from a persisted offset triple (used
        on recovery; only the change-detection fields matter)."""
        meta = cls.__new__(cls)
        meta.path = path
        meta.created_at = created_at
        meta.modified_at = modified_at
        meta.size = size
        meta.seen_at = int(time.time())
        meta.status = STATUS_DOWNLOADED
        meta.base_url = None
        return meta

    def as_offset(self) -> list:
        return [self.created_at, self.modified_at, self.size]

    def __eq__(self, other):
        if not isinstance(other, _EntryMeta):
            return NotImplemented
        return (
            self.created_at == other.created_at
            and self.modified_at == other.modified_at
            and self.path == other.path
            and self.size == other.size
        )

    @property
    def url(self) -> str | None:
        if self.base_url:
            return f"{self.base_url}{quote(self.path)}"
        return None

    def as_dict(self) -> dict:
        return {
            "created_at": self.created_at,
            "modified_at": self.modified_at,
            "path": self.path,
            "size": self.size,
            "seen_at": self.seen_at,
            "status": self.status,
            "url": self.url or "",
        }


class _Scanner:
    """One polling pass: list files, diff against stored metadata, fetch
    changed payloads (respecting the size limit), detect deletions
    (reference _SharePointScanner.get_snapshot_diff :104-143)."""

    def __init__(
        self,
        context: SharePointContext,
        root_path: str,
        recursive: bool,
        stored_metadata: dict[str, _EntryMeta],
        object_size_limit: int | None = None,
        base_url: str | None = None,
    ):
        self._context = context
        self._root_path = root_path
        self._recursive = recursive
        self._stored_metadata = stored_metadata
        self._object_size_limit = object_size_limit
        self._base_url = base_url

    def get_snapshot_diff(self) -> tuple[list[tuple[bytes, _EntryMeta]], list[str]]:
        # Divergence from the reference (which mutates stored_metadata
        # mid-scan, :127-141): diff into a scratch snapshot and swap it
        # in only when the whole scan succeeds — a payload fetch failing
        # halfway must not mark earlier files as already-ingested, or
        # their updates are silently lost on retry.
        updated: list[tuple[bytes, _EntryMeta]] = []
        new_stored: dict[str, _EntryMeta] = {}
        for file in self._context.list_files(self._root_path, self._recursive):
            meta = _EntryMeta(file, base_url=self._base_url)
            over_limit = (
                self._object_size_limit is not None
                and meta.size > self._object_size_limit
            )
            if over_limit:
                meta.status = STATUS_SIZE_LIMIT_EXCEEDED
                logging.info(
                    "Skipping object %s: size %d exceeds the limit %d",
                    meta.path,
                    meta.size,
                    self._object_size_limit,
                )
            if self._stored_metadata.get(meta.path) != meta:
                payload = b"" if over_limit else file.read()
                updated.append((payload, meta))
            new_stored[meta.path] = meta
        deleted = [p for p in self._stored_metadata if p not in new_stored]
        self._stored_metadata.clear()
        self._stored_metadata.update(new_stored)
        return updated, deleted


def _schema(with_metadata: bool) -> type[Schema]:
    cols: dict[str, Any] = {"data": ColumnDefinition(dtype=dt.BYTES)}
    if with_metadata:
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
    return schema_builder(cols, name="SharePointSchema")


def read(
    url: str,
    *,
    tenant: str | None = None,
    client_id: str | None = None,
    cert_path: str | None = None,
    thumbprint: str | None = None,
    root_path: str,
    mode: str = "streaming",
    recursive: bool = True,
    object_size_limit: int | None = None,
    with_metadata: bool = False,
    refresh_interval: int = 30,
    max_failed_attempts_in_row: int | None = 8,
    name: str = "sharepoint",
    persistent_id: str | None = None,
    autocommit_duration_ms: int | None = 1500,
    _context_factory: Any = None,
) -> Table:
    """Read a directory (or file) of a Microsoft SharePoint site as a
    table with a binary ``data`` column (reference
    sharepoint/__init__.py:255-376). Requires an enterprise license.

    Args mirror the reference: ``url`` is the site URL
    (``https://company.sharepoint.com/sites/MySite``), ``tenant``/
    ``client_id``/``cert_path``/``thumbprint`` authenticate the app
    certificate, ``root_path`` is the folder to scan.  ``mode`` is
    ``"streaming"`` (poll every ``refresh_interval`` s; updates upsert,
    deletions retract) or ``"static"`` (one snapshot, then EOF).
    ``object_size_limit`` skips payloads of oversized files (their row
    carries empty bytes and ``_metadata.status`` =
    ``"size_limit_exceeded"``).  ``max_failed_attempts_in_row`` bounds
    consecutive scan failures before the connector aborts (``None`` =
    retry forever).  ``_context_factory`` injects a fake client for
    tests."""
    key = pathway_config.license_key or get_pathway_config().license_key
    License.new(key).check_entitlement("xpack-sharepoint")
    if mode not in ("streaming", "static"):
        raise ValueError(f"unknown mode {mode!r}; expected 'streaming' or 'static'")
    if _context_factory is None:
        missing = [
            arg
            for arg, val in (
                ("tenant", tenant),
                ("client_id", client_id),
                ("cert_path", cert_path),
                ("thumbprint", thumbprint),
            )
            if val is None
        ]
        if missing:
            raise TypeError(
                f"sharepoint.read() missing required arguments: {', '.join(missing)}"
            )
        # probe the client dependency now: a missing package is a
        # configuration error, not a transient scan failure to retry
        # for minutes on the reader thread
        try:
            import office365.sharepoint.client_context  # type: ignore  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "pw.xpacks.connectors.sharepoint requires the "
                "'Office365-REST-Python-Client' package"
            ) from e

    parsed = urlparse(url)
    base_url = f"{parsed.scheme}://{parsed.netloc}" if parsed.netloc else None

    def context_factory() -> SharePointContext:
        if _context_factory is not None:
            return _context_factory()
        return _Office365Context(url, tenant, client_id, thumbprint, cert_path)

    schema = _schema(with_metadata)

    def reader(ctx: StreamingContext) -> None:
        # recovery: rebuild the metadata snapshot from persisted offsets
        # so a restart diffs against the last checkpoint — unchanged
        # files skip re-download, files deleted during downtime retract
        # (the same contract as io/_object_store.py's offsets)
        stored: dict[str, _EntryMeta] = {}
        for path, triple in ctx.offsets.items():
            if isinstance(path, str) and isinstance(triple, (list, tuple)) and len(triple) == 3:
                stored[path] = _EntryMeta.from_parts(path, *triple)
        scanner = None
        failures = 0
        while True:
            try:
                if scanner is None:
                    scanner = _Scanner(
                        context_factory(),
                        root_path,
                        recursive,
                        stored,
                        object_size_limit,
                        base_url=base_url,
                    )
                updated, deleted = scanner.get_snapshot_diff()
                failures = 0
            except Exception as e:
                failures += 1
                scanner = None  # re-authenticate on next attempt
                if (
                    max_failed_attempts_in_row is not None
                    and failures >= max_failed_attempts_in_row
                ):
                    raise
                logging.error(
                    "Failed to get SharePoint snapshot diff: %s. Retrying in %s seconds...",
                    e,
                    refresh_interval,
                )
                if ctx.wait_stopped(refresh_interval):
                    return
                continue

            for path in deleted:
                ctx.upsert_keyed((path,), None)
                ctx.set_offset(path, None)
            for payload, meta in updated:
                row: dict[str, Any] = {"data": payload}
                if with_metadata:
                    row["_metadata"] = Json(meta.as_dict())
                # the offset triple lands in the same locked append as the
                # row, so a concurrent commit never persists one without
                # the other
                ctx.upsert_keyed((meta.path,), row, offsets={meta.path: meta.as_offset()})
            if updated or deleted:
                ctx.commit()

            if mode == "static" or ctx.wait_stopped(refresh_interval):
                return

    return input_table_from_reader(
        schema,
        reader,
        name=name,
        autocommit_duration_ms=autocommit_duration_ms,
        persistent_id=persistent_id,
        supports_offsets=True,
    )


__all__ = ["read", "STATUS_DOWNLOADED", "STATUS_SIZE_LIMIT_EXCEEDED"]
