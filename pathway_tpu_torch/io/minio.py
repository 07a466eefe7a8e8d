"""pw.io.minio — MinIO (S3-compatible) reader.

The port's copy of the reference's ``io/minio.py`` (upstream Pathway's
python/pathway/io/minio/__init__.py): a settings wrapper that fills the S3
endpoint, then delegates to the shared S3 scanner (pw.io.s3.read)."""

from __future__ import annotations

from ..internals.schema import Schema
from ..internals.table import Table
from .s3 import AwsS3Settings
from . import s3 as _s3


class MinIOSettings:
    def __init__(
        self,
        endpoint: str,
        bucket_name: str,
        access_key: str,
        secret_access_key: str,
        *,
        with_path_style: bool = True,
        region: str | None = None,
    ):
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region

    def create_aws_settings(self) -> AwsS3Settings:
        endpoint = self.endpoint
        if "://" not in endpoint:
            endpoint = "https://" + endpoint
        return AwsS3Settings(
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            with_path_style=self.with_path_style,
            region=self.region,
            endpoint=endpoint,
        )


def read(
    path: str,
    minio_settings: MinIOSettings,
    *,
    schema: type[Schema] | None = None,
    **kwargs,
) -> Table:
    return _s3.read(
        path,
        aws_s3_settings=minio_settings.create_aws_settings(),
        schema=schema,
        name="minio",
        **kwargs,
    )
