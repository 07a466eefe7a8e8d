"""pw.io.plaintext: the port's copy of the reference's ``io/plaintext.py``
(upstream Pathway's python/pathway/io/plaintext)."""

from __future__ import annotations

from ..internals.table import Table
from . import fs as _fs


def read(
    path: str,
    *,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str = "plaintext",
    **kwargs,
) -> Table:
    return _fs.read(
        path,
        format="plaintext",
        mode=mode,
        with_metadata=with_metadata,
        autocommit_duration_ms=autocommit_duration_ms,
        name=name,
        **kwargs,
    )
