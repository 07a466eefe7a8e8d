"""pw.io.debezium: Debezium CDC source.

The port's copy of the reference's ``io/debezium.py`` (upstream Pathway's
src/connectors/data_format.rs DebeziumMessageParser :1053 and
python/pathway/io/debezium/__init__.py read): change events arrive on a
Kafka topic as key/value JSON envelopes; ``payload.op`` r/c/u/d maps to
inserts/deletes (postgres-style, which carries ``before``) or keyed
upserts (mongodb-style, which does not). The consumer is injectable
(``_consumer``: an iterable of (key_bytes, value_bytes)) so the whole
parse/apply loop unit-tests without a broker; otherwise it is
``pw.io.kafka``'s consumer.
"""

from __future__ import annotations

from ..internals.schema import Schema
from ..internals.table import Table
from ._connector import StreamingContext, input_table_from_reader
from ._formats import DebeziumMessageParser
from .kafka import _get_consumer


def read(
    rdkafka_settings: dict,
    topic_name: str | None = None,
    *,
    schema: type[Schema],
    db_type: str = "postgres",
    autocommit_duration_ms: int | None = 1500,
    name: str = "debezium",
    persistent_id: str | None = None,
    _consumer=None,
    **kwargs,
) -> Table:
    parser = DebeziumMessageParser(
        value_field_names=schema.column_names(), db_type=db_type
    )

    # keyless topics: content identity must preserve MULTIPLICITY (two
    # identical inserts are two rows; one delete removes one) — track a
    # per-content counter so each instance gets a distinct key
    multiplicity: dict[tuple, int] = {}

    def apply_events(ctx: StreamingContext, key_payload, value_payload) -> None:
        for event in parser.parse(key_payload, value_payload):
            op, values, key_values = event
            if key_values is not None:
                # the Debezium key payload IS the row's primary key, so
                # every op is a keyed upsert: r/c/u set the after-state,
                # d clears it (reference upsert session, adaptors.rs:176)
                kt = _key_tuple(key_values)
                ctx.upsert_keyed(kt, None if op == "delete" else values)
                continue
            if op == "upsert":
                # mongodb envelopes carry no before-state: without a key
                # payload there is nothing to correlate an update/delete
                # with — appending would silently accumulate stale rows
                raise ValueError(
                    "debezium mongodb events need a key payload to "
                    "correlate updates/deletes; this topic has none"
                )
            content = tuple(str(values.get(n)) for n in schema.column_names())
            if op == "delete":
                n = multiplicity.get(content, 0)
                if n > 0:
                    multiplicity[content] = n - 1
                    ctx.upsert_keyed((*content, n - 1), None)
            else:
                n = multiplicity.get(content, 0)
                multiplicity[content] = n + 1
                ctx.upsert_keyed((*content, n), values)

    def reader(ctx: StreamingContext) -> None:
        if _consumer is not None:
            for key_payload, value_payload in _consumer:
                apply_events(ctx, key_payload, value_payload)
            ctx.commit()
            return
        kind, consumer = _get_consumer(rdkafka_settings, topic_name)
        try:
            if kind == "confluent":
                while not ctx.wait_stopped(0):
                    msg = consumer.poll(timeout=1.0)
                    if msg is None:
                        ctx.commit()
                        continue
                    if msg.error():
                        continue
                    apply_events(ctx, msg.key(), msg.value())
            else:
                for msg in consumer:
                    apply_events(ctx, msg.key, msg.value)
        finally:
            try:
                consumer.close()
            except Exception:
                pass

    return input_table_from_reader(
        schema,
        reader,
        name=name,
        autocommit_duration_ms=autocommit_duration_ms,
        persistent_id=persistent_id,
    )


def _key_tuple(key_values) -> tuple:
    if isinstance(key_values, dict):
        return tuple(v for _k, v in sorted(key_values.items()))
    return (key_values,)
