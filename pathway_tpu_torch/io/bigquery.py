"""pw.io.bigquery: BigQuery sink.

The port's copy of the reference's ``io/bigquery.py`` (upstream Pathway's
python/pathway/io/bigquery/__init__.py write :55 with its
_OutputBuffer :13): changes buffer into batches and stream via
``insert_rows_json`` with time/diff fields. The client is injectable
(``_client``) so the buffer/flush loop unit-tests against a fake;
google-cloud-bigquery is only needed for real projects.
"""

from __future__ import annotations

from typing import Any

from ..internals.table import Table
from ._connector import add_output_sink
from ._formats import BsonFormatter

_DEFAULT_BATCH = 500


def write(
    table: Table,
    dataset_name: str,
    table_name: str,
    *,
    service_user_credentials_file: str | None = None,
    max_batch_size: int = _DEFAULT_BATCH,
    _client: Any = None,
) -> None:
    fmt = BsonFormatter(table.column_names())  # plain dict rows
    target = f"{dataset_name}.{table_name}"
    state: dict = {"batch": []}

    def on_build(runner):
        if _client is not None:
            state["client"] = _client
            return
        try:
            from google.cloud import bigquery  # type: ignore
            from google.oauth2.service_account import Credentials  # type: ignore
        except ImportError as e:
            raise ImportError(
                "pw.io.bigquery requires the 'google-cloud-bigquery' package"
            ) from e
        creds = (
            Credentials.from_service_account_file(service_user_credentials_file)
            if service_user_credentials_file
            else None
        )
        state["client"] = bigquery.Client(credentials=creds)

    def flush():
        if state["batch"]:
            errors = state["client"].insert_rows_json(target, state["batch"])
            if errors:
                raise RuntimeError(f"bigquery insert failed: {errors}")
            state["batch"] = []

    def on_change(key, row, time, diff):
        state["batch"].append(fmt.format(row, time, diff))
        if len(state["batch"]) >= max_batch_size:
            flush()

    add_output_sink(
        table, on_change, on_end=flush, name="bigquery.write", on_build=on_build
    )
