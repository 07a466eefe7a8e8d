"""pw.io.s3 — S3-compatible object storage reader.

The port's copy of the reference's ``io/s3.py`` (upstream Pathway's S3
scanner, src/connectors/scanner/s3.rs + posix_like.rs:279; python API
python/pathway/io/s3/__init__.py: read :94, read_from_digital_ocean :304,
read_from_wasabi :435). Objects under a
prefix stream through the shared object-store scanner (keyed upserts,
ETag-versioned, resumable offsets). The client is injectable
(``_client``) so the whole list/fetch/upsert loop unit-tests against a
fake bucket; boto3 is only needed for real S3.
"""

from __future__ import annotations

from typing import Any

from ..internals.schema import Schema
from ..internals.table import Table
from ._object_store import read_object_store


class AwsS3Settings:
    """Connection settings for S3-compatible stores (reference
    io/s3 AwsS3Settings / DigitalOceanS3Settings :22 / WasabiS3Settings
    :57 — one class with an endpoint covers all of them)."""

    def __init__(
        self,
        *,
        bucket_name: str | None = None,
        access_key: str | None = None,
        secret_access_key: str | None = None,
        with_path_style: bool = False,
        region: str | None = None,
        endpoint: str | None = None,
        session_token: str | None = None,
    ):
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.region = region
        self.endpoint = endpoint
        self.session_token = session_token

    def create_client(self):
        try:
            import boto3  # type: ignore
            from botocore.config import Config  # type: ignore
        except ImportError as e:
            raise ImportError(
                "pw.io.s3 requires the 'boto3' package to be installed"
            ) from e
        cfg = Config(
            s3={"addressing_style": "path" if self.with_path_style else "auto"}
        )
        return boto3.client(
            "s3",
            aws_access_key_id=self.access_key,
            aws_secret_access_key=self.secret_access_key,
            aws_session_token=self.session_token,
            region_name=self.region,
            endpoint_url=self.endpoint,
            config=cfg,
        )


class _S3Client:
    """ObjectStoreClient over a boto3-style s3 client."""

    def __init__(self, s3, bucket: str, prefix: str):
        self.s3 = s3
        self.bucket = bucket
        self.prefix = prefix

    def list_objects(self):
        token = None
        while True:
            kw = {"Bucket": self.bucket, "Prefix": self.prefix}
            if token:
                kw["ContinuationToken"] = token
            resp = self.s3.list_objects_v2(**kw)
            for obj in resp.get("Contents", []):
                yield obj["Key"], obj.get("ETag") or obj.get("LastModified")
            if not resp.get("IsTruncated"):
                return
            token = resp.get("NextContinuationToken")

    def get_object(self, key: str) -> bytes:
        return self.s3.get_object(Bucket=self.bucket, Key=key)["Body"].read()


def _split_path(path: str, settings: AwsS3Settings | None) -> tuple[str, str]:
    """'s3://bucket/prefix' or 'prefix' (bucket from settings)."""
    from ..utils.uri import split_s3_path

    bucket, prefix = split_s3_path(path)
    if bucket is not None:
        return bucket, prefix
    bucket = settings.bucket_name if settings else None
    if not bucket:
        raise ValueError("pass aws_s3_settings with bucket_name or an s3:// path")
    return bucket, prefix


def read(
    path: str,
    *,
    aws_s3_settings: AwsS3Settings | None = None,
    format: str = "plaintext",
    schema: type[Schema] | None = None,
    mode: str = "streaming",
    with_metadata: bool = False,
    autocommit_duration_ms: int | None = 1500,
    name: str = "s3",
    persistent_id: str | None = None,
    _client: Any = None,
    **kwargs,
) -> Table:
    """Read objects under an S3 prefix as a (streaming) table
    (reference io/s3 read :78).

    Args:
        path: ``s3://bucket/prefix`` (bucket may instead come from
            ``aws_s3_settings``). Every object under the prefix is
            decoded with ``format``.
        aws_s3_settings: :class:`AwsS3Settings` — bucket, region,
            endpoint (MinIO/Wasabi/DigitalOcean work via a custom
            endpoint), access keys or profile.
        format: ``"plaintext"`` (one row per line), ``"plaintext_by_file"``
            / ``"binary"`` (one row per object), ``"csv"``,
            ``"json"``/``"jsonlines"``.
        schema: payload schema for csv/jsonlines formats.
        mode: ``"streaming"`` re-lists the prefix and emits
            upserts/retractions as objects appear, change (version/etag
            diff) or disappear; ``"static"`` snapshots once.
        with_metadata: add a ``_metadata`` column (object key, size,
            version) per row.
        csv_settings: (kwarg) :class:`pw.io.CsvParserSettings` CSV
            dialect for ``format="csv"``.
        persistent_id: checkpoint/recovery — restarts skip objects whose
            version was already ingested, and the cached object store
            avoids re-downloading unchanged objects entirely.
        _client: injectable boto3-shaped client (tests run against a
            fake; production uses ``aws_s3_settings.create_client()``).
        retry_policy: (kwarg) :class:`~pathway_tpu_torch.resilience.RetryPolicy`
            — transient list/fetch exceptions restart the poller with
            backoff instead of failing the run.
    """
    bucket, prefix = _split_path(path, aws_s3_settings)

    def client_factory():
        s3 = _client if _client is not None else aws_s3_settings.create_client()
        return _S3Client(s3, bucket, prefix)

    return read_object_store(
        client_factory,
        format=format,
        schema=schema,
        mode=mode,
        with_metadata=with_metadata,
        autocommit_duration_ms=autocommit_duration_ms,
        name=f"{name}:{path}",
        persistent_id=persistent_id,
        **kwargs,
    )


def read_from_digital_ocean(path: str, do_s3_settings: AwsS3Settings, **kwargs) -> Table:
    return read(path, aws_s3_settings=do_s3_settings, name="digital_ocean", **kwargs)


def read_from_wasabi(path: str, wasabi_s3_settings: AwsS3Settings, **kwargs) -> Table:
    return read(path, aws_s3_settings=wasabi_s3_settings, name="wasabi", **kwargs)
