"""pw.io.elasticsearch: ElasticSearch sink.

The port's copy of the reference's ``io/elasticsearch.py`` (upstream
Pathway's src/connectors/data_storage.rs ElasticSearchWriter :1336 and
python/pathway/io/elasticsearch/__init__.py write :52): every change
indexes a JSON document carrying the row plus time/diff. The client is
injectable (``_client``) so the format/index loop unit-tests against a
fake; the ``elasticsearch`` package is only needed for real clusters.
"""

from __future__ import annotations

from typing import Any

from ..internals.table import Table
from ._connector import add_output_sink
from ._formats import BsonFormatter


class ElasticSearchAuth:
    """(reference io/elasticsearch ElasticSearchAuth :12)"""

    def __init__(self, kind: str, **kwargs):
        self.kind = kind
        self.kwargs = kwargs

    @classmethod
    def basic(cls, username: str, password: str) -> "ElasticSearchAuth":
        return cls("basic", basic_auth=(username, password))

    @classmethod
    def apikey(cls, api_key: str, api_key_id: str | None = None) -> "ElasticSearchAuth":
        key = (api_key_id, api_key) if api_key_id else api_key
        return cls("apikey", api_key=key)

    @classmethod
    def bearer(cls, bearer: str) -> "ElasticSearchAuth":
        return cls("bearer", bearer_auth=bearer)

    def as_client_kwargs(self) -> dict:
        return dict(self.kwargs)


def write(
    table: Table,
    host: str,
    auth: ElasticSearchAuth | None,
    index_name: str,
    *,
    _client: Any = None,
) -> None:
    """Index the table's stream of changes into ``index_name``."""
    fmt = BsonFormatter(table.column_names())  # plain dict docs
    state: dict = {}

    def on_build(runner):
        if _client is not None:
            state["client"] = _client
            return
        try:
            from elasticsearch import Elasticsearch  # type: ignore
        except ImportError as e:
            raise ImportError(
                "pw.io.elasticsearch requires the 'elasticsearch' package"
            ) from e
        kwargs = auth.as_client_kwargs() if auth is not None else {}
        state["client"] = Elasticsearch(host, **kwargs)

    def on_change(key, row, time, diff):
        state["client"].index(index=index_name, document=fmt.format(row, time, diff))

    def on_end():
        client = state.get("client")
        if client is not None and hasattr(client, "close"):
            client.close()

    add_output_sink(
        table, on_change, on_end=on_end, name="elasticsearch.write", on_build=on_build
    )
