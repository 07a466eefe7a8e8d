"""pw.io.s3_csv — CSV-over-S3 reader.

The port's copy of the reference's ``io/s3_csv.py`` (upstream Pathway's
python/pathway/io/s3_csv/__init__.py): pw.io.s3.read pinned to the csv
format."""

from __future__ import annotations

from ..internals.schema import Schema
from ..internals.table import Table
from . import s3 as _s3
from .s3 import AwsS3Settings  # noqa: F401  (re-export, reference parity)


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    schema: type[Schema] | None = None,
    **kwargs,
) -> Table:
    kwargs.pop("format", None)
    return _s3.read(
        path,
        aws_s3_settings=aws_s3_settings,
        format="csv",
        schema=schema,
        name="s3_csv",
        **kwargs,
    )
