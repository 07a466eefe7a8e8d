"""pw.io: connectors.

The port's copy of the reference's ``io`` package. Local connectors (fs,
csv, jsonlines, plaintext, python, http, sqlite, null, subscribe) run
standalone; the service-backed connectors (kafka, redpanda, debezium,
postgres, mongodb, elasticsearch, nats, bigquery, pubsub, logstash, slack)
and the object stores (s3, s3_csv, minio, gdrive, pyfilesystem, deltalake,
airbyte) run their full read / parse / commit or format / write loop over
an injectable client, and import their client libraries only when a run
needs a real one. ``add_output_sink`` is the sink hook the connectors
build on.
"""

from __future__ import annotations

from . import csv, fs, http, jsonlines, null, plaintext, python
from ._connector import add_output_sink
from ._formats import CsvParserSettings
from ._subscribe import OnChangeCallback, OnFinishCallback, subscribe

# service-backed connectors (client libraries needed only at run time)
from . import bigquery, debezium, elasticsearch, kafka, logstash, mongodb, nats, postgres, pubsub, redpanda, slack, sqlite

# object stores (boto3, deltalake, the Drive, fs and Airbyte clients needed only at run time)
from . import airbyte, deltalake, gdrive, minio, pyfilesystem, s3, s3_csv

__all__ = [
    "CsvParserSettings",
    "OnChangeCallback",
    "OnFinishCallback",
    "add_output_sink",
    "airbyte",
    "bigquery",
    "csv",
    "debezium",
    "deltalake",
    "elasticsearch",
    "fs",
    "gdrive",
    "http",
    "jsonlines",
    "kafka",
    "logstash",
    "minio",
    "mongodb",
    "nats",
    "null",
    "plaintext",
    "postgres",
    "pubsub",
    "pyfilesystem",
    "python",
    "redpanda",
    "s3",
    "s3_csv",
    "slack",
    "sqlite",
    "subscribe",
]
