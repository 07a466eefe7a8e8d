"""Shared URI helpers (used by pw.io.s3 and the S3 persistence backend)."""

from __future__ import annotations


def split_s3_path(path: str) -> tuple[str | None, str]:
    """'s3://bucket/prefix' -> (bucket, prefix); bare 'prefix' ->
    (None, prefix) — the caller supplies the bucket from settings.
    Trailing slashes are preserved (they distinguish the 'data/'
    directory prefix from a 'data*' name prefix in object listings)."""
    if path.startswith("s3://"):
        rest = path[len("s3://") :]
        bucket, _, prefix = rest.partition("/")
        return bucket, prefix
    return None, path
