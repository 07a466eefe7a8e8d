"""pw.io.pyfilesystem — read from any PyFilesystem FS object.

The port's copy of the reference's ``io/pyfilesystem.py`` (upstream
Pathway's python/pathway/io/pyfilesystem/__init__.py: _PyFilesystemSubject
:28, read :142): the `fs` package's FS objects
(zip, tar, ftp, s3fs, mem, …) expose walk/readbytes/getinfo — which is
exactly the object-store scanner contract, so any FS streams through
the shared keyed-upsert loop."""

from __future__ import annotations

from typing import Any

from ..internals.schema import Schema
from ..internals.table import Table
from ._object_store import read_object_store


class _PyFsClient:
    def __init__(self, source, path: str):
        self.source = source
        self.path = path

    def list_objects(self):
        for p in self.source.walk.files(self.path):
            try:
                info = self.source.getinfo(p, namespaces=["details"])
                version = (info.size, str(info.modified) if info.modified else None)
            except Exception:
                version = None
            yield p, version

    def get_object(self, key: str) -> bytes:
        return self.source.readbytes(key)


def read(
    source: Any,
    path: str = "/",
    *,
    format: str = "binary",
    mode: str = "streaming",
    with_metadata: bool = False,
    schema: type[Schema] | None = None,
    refresh_interval: int = 30,
    name: str = "pyfilesystem",
    persistent_id: str | None = None,
    **kwargs,
) -> Table:
    """``source`` is an fs.base.FS (e.g. ``fs.open_fs("mem://")``)."""
    return read_object_store(
        lambda: _PyFsClient(source, path),
        format=format,
        schema=schema,
        mode=mode,
        with_metadata=with_metadata,
        name=f"{name}:{path}",
        persistent_id=persistent_id,
        poll_interval_s=float(refresh_interval),
        **kwargs,
    )
