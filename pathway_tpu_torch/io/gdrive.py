"""pw.io.gdrive — Google Drive source.

The port's copy of the reference's ``io/gdrive.py`` (upstream Pathway's
python/pathway/io/gdrive/__init__.py: _GDriveClient :73, _GDriveSubject
:261, read :336): a Drive folder is
scanned like an object store — files list with their version/md5,
changed files re-download, deletions retract. The Drive client is
injectable (``_client`` — list_objects()/get_object()) so the scanner
unit-tests without Google credentials; google-api-python-client is only
needed for real drives.
"""

from __future__ import annotations

from typing import Any

from ..internals.schema import Schema
from ..internals.table import Table
from ._object_store import read_object_store


class _GDriveClient:
    """ObjectStoreClient over the Drive v3 API."""

    def __init__(self, object_id: str, credentials_file: str):
        try:
            from google.oauth2.service_account import Credentials  # type: ignore
            from googleapiclient.discovery import build  # type: ignore
        except ImportError as e:
            raise ImportError(
                "pw.io.gdrive requires the 'google-api-python-client' package"
            ) from e
        creds = Credentials.from_service_account_file(
            credentials_file, scopes=["https://www.googleapis.com/auth/drive.readonly"]
        )
        self.service = build("drive", "v3", credentials=creds)
        self.object_id = object_id

    def list_objects(self):
        page_token = None
        sizes: dict[str, int] = {}
        entries = []
        while True:
            resp = (
                self.service.files()
                .list(
                    q=f"'{self.object_id}' in parents and trashed=false",
                    fields="nextPageToken, files(id, name, md5Checksum, modifiedTime, size)",
                    pageToken=page_token,
                )
                .execute()
            )
            for f in resp.get("files", []):
                if "size" in f:
                    sizes[f["id"]] = int(f["size"])
                entries.append((f["id"], f.get("md5Checksum") or f.get("modifiedTime")))
            page_token = resp.get("nextPageToken")
            if not page_token:
                # swap per listing: ids of deleted files must not
                # accumulate (nor serve stale sizes)
                self.sizes = sizes
                return entries

    def get_object(self, key: str) -> bytes:
        try:
            return self.service.files().get_media(fileId=key).execute()
        except Exception as e:
            # Google-native files (Docs/Sheets) have no binary media:
            # emit an empty payload instead of killing the reader, like
            # the reference's not-downloadable handling (gdrive
            # __init__.py STATUS_SYMLINKS_NOT_SUPPORTED)
            if "ownloadable" in str(e):
                return b""
            raise


def read(
    object_id: str,
    *,
    mode: str = "streaming",
    format: str = "binary",
    object_size_limit: int | None = None,
    service_user_credentials_file: str | None = None,
    with_metadata: bool = False,
    refresh_interval: int = 30,
    schema: type[Schema] | None = None,
    name: str = "gdrive",
    persistent_id: str | None = None,
    _client: Any = None,
    **kwargs,
) -> Table:
    """Read a Google Drive file or folder as a table of file payloads
    (reference io/gdrive read :478).

    Args:
        object_id: Drive id of a file or folder (folders are walked
            recursively; shortcuts/symlinks are skipped like the
            reference's STATUS_SYMLINKS_NOT_SUPPORTED path).
        mode: ``"streaming"`` polls every ``refresh_interval`` seconds
            and emits upserts for new/modified files and retractions
            for deleted ones; ``"static"`` snapshots once.
        format: ``"binary"`` (one row per file) or any pw.io.fs format.
        object_size_limit: files larger than this many bytes are
            skipped (a warning row in the error log), matching the
            reference's size gate.
        service_user_credentials_file: path to a service-account JSON
            key; the account needs read access to the objects.
        with_metadata: add ``_metadata`` (id, name, mtime, size).
        refresh_interval: poll period in seconds.
        persistent_id: checkpoint/recovery — unchanged files (by
            version) are not re-downloaded on restart.
        _client: injectable Drive client for tests.
    """

    def client_factory():
        if _client is not None:
            return _client
        return _GDriveClient(object_id, service_user_credentials_file)

    return read_object_store(
        client_factory,
        format=format,
        schema=schema,
        mode=mode,
        with_metadata=with_metadata,
        name=f"{name}:{object_id}",
        persistent_id=persistent_id,
        poll_interval_s=float(refresh_interval),
        object_size_limit=object_size_limit,
        **kwargs,
    )
