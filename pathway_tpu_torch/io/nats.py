"""pw.io.nats: NATS source and sink.

The port's copy of the reference's ``io/nats.py`` (upstream Pathway's
src/connectors/data_storage.rs NatsReader :2271, NatsWriter :2345 and
python/pathway/io/nats/__init__.py read :23, write :154): subjects
stream JSON (or raw) messages into a table; writes publish each change
as JSON with time/diff. The client is injectable (``_subscription``: an
iterable of payload bytes; ``_publisher``: an object with
publish(subject, payload)) so the loops unit-test without a server;
``nats-py`` is only needed for real deployments.
"""

from __future__ import annotations

import json
from typing import Any

from ..internals import dtype as dt
from ..internals.schema import ColumnDefinition, Schema, schema_builder
from ..internals.table import Table
from ._connector import StreamingContext, add_output_sink, input_table_from_reader
from ._formats import JsonLinesFormatter


def _run_async_subscriber(uri: str, topic: str, on_payload) -> None:
    try:
        import asyncio

        import nats  # type: ignore
    except ImportError as e:
        raise ImportError("pw.io.nats requires the 'nats-py' package") from e

    async def main():
        nc = await nats.connect(uri)
        sub = await nc.subscribe(topic)
        async for msg in sub.messages:
            on_payload(msg.data)

    asyncio.run(main())


def read(
    uri: str,
    topic: str,
    *,
    schema: type[Schema] | None = None,
    format: str = "json",
    autocommit_duration_ms: int | None = 1500,
    name: str = "nats",
    persistent_id: str | None = None,
    parallel_readers: bool = False,
    _subscription=None,
    **kwargs,
) -> Table:
    if schema is None:
        if format != "raw":
            raise ValueError("nats.read requires schema= for json format")
        schema = schema_builder(
            {"data": ColumnDefinition(dtype=dt.BYTES)}, name="NatsRaw"
        )

    def emit(ctx: StreamingContext, payload: bytes) -> None:
        if format == "raw":
            ctx.insert({"data": payload})
            return
        try:
            rec = json.loads(payload)
        except (ValueError, TypeError):
            return
        if isinstance(rec, dict):
            ctx.insert(rec)

    def reader(ctx: StreamingContext) -> None:
        if _subscription is not None:
            for i, payload in enumerate(_subscription):
                if (
                    parallel_readers
                    and ctx.n_processes > 1
                    and i % ctx.n_processes != ctx.process_id
                ):
                    continue  # another process's queue-group share
                emit(ctx, payload)
            ctx.commit()
            return
        # real NATS: queue groups split the subject across processes
        _run_async_subscriber(uri, topic, lambda p: emit(ctx, p))

    return input_table_from_reader(
        schema,
        reader,
        name=name,
        autocommit_duration_ms=autocommit_duration_ms,
        persistent_id=persistent_id,
        parallel_readers=parallel_readers,
    )


def write(
    table: Table,
    uri: str,
    topic: str,
    *,
    format: str = "json",
    _publisher: Any = None,
) -> None:
    fmt = JsonLinesFormatter(table.column_names())
    state: dict = {}

    def on_build(runner):
        if _publisher is not None:
            state["pub"] = _publisher
            return
        try:
            import asyncio

            import nats  # type: ignore
        except ImportError as e:
            raise ImportError("pw.io.nats requires the 'nats-py' package") from e

        class _SyncPublisher:
            def __init__(self):
                self.loop = asyncio.new_event_loop()
                self.nc = self.loop.run_until_complete(nats.connect(uri))

            def publish(self, subject, payload):
                self.loop.run_until_complete(self.nc.publish(subject, payload))

            def close(self):
                self.loop.run_until_complete(self.nc.drain())
                self.loop.close()

        state["pub"] = _SyncPublisher()

    def on_change(key, row, time, diff):
        state["pub"].publish(topic, fmt.format(row, time, diff).encode())

    def on_end():
        pub = state.get("pub")
        if pub is not None and hasattr(pub, "close"):
            pub.close()

    add_output_sink(
        table, on_change, on_end=on_end, name="nats.write", on_build=on_build
    )
