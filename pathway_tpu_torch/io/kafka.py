"""pw.io.kafka: Kafka source and sink.

The port's copy of the reference's ``io/kafka.py`` (upstream Pathway's
python/pathway/io/kafka, 686 LoC; the engine's KafkaReader
src/connectors/data_storage.rs:692 and KafkaWriter :1258). A Kafka client
library (confluent_kafka or kafka-python) is imported at call time, as
in the reference; without one and without an injected client the same
``ImportError`` is raised. The dataflow side (reader thread →
``InputSession``, message parsing, commits) is implemented here. A
confluent consumer's poll loop ends once its run has ended.
"""

from __future__ import annotations

import json
from typing import Any

from ..internals import dtype as dt
from ..internals.schema import Schema, schema_builder, ColumnDefinition
from ..internals.table import Table
from ._connector import StreamingContext, input_table_from_reader, add_output_sink


def _get_consumer(
    rdkafka_settings: dict,
    topic,
    start_from_timestamp_ms: int | None = None,
):
    topics = [topic] if isinstance(topic, str) else list(topic)
    try:
        from confluent_kafka import Consumer, TopicPartition  # type: ignore

        consumer = Consumer(rdkafka_settings)

        def on_assign(cons, partitions):
            # seek to the first offset at/after the requested timestamp
            # (reference start_from_timestamp_ms semantics)
            if start_from_timestamp_ms is None:
                return
            lookup = [
                TopicPartition(p.topic, p.partition, start_from_timestamp_ms)
                for p in partitions
            ]
            try:
                resolved = cons.offsets_for_times(lookup, timeout=10.0)
                # offsets_for_times returns offset=-1 for partitions with
                # no message at/after the timestamp; assigning -1 falls
                # back to auto.offset.reset (commonly 'earliest') and
                # replays history — start those at the end instead
                from confluent_kafka import OFFSET_END  # type: ignore

                for tp in resolved:
                    if tp.offset < 0:
                        tp.offset = OFFSET_END
                cons.assign(resolved)
            except Exception:
                # keep the ORIGINAL assignment (timestamps are not
                # offsets; seeking to one lands out of range)
                cons.assign(partitions)

        consumer.subscribe(topics, on_assign=on_assign)
        return ("confluent", consumer)
    except ImportError:
        pass
    try:
        from kafka import KafkaConsumer  # type: ignore

        sec = {
            k_py: rdkafka_settings[k_rd]
            for k_rd, k_py in (
                ("security.protocol", "security_protocol"),
                ("sasl.mechanism", "sasl_mechanism"),
                ("sasl.mechanisms", "sasl_mechanism"),  # librdkafka plural
                ("sasl.username", "sasl_plain_username"),
                ("sasl.password", "sasl_plain_password"),
            )
            if k_rd in rdkafka_settings
        }
        consumer = KafkaConsumer(
            *topics,
            bootstrap_servers=rdkafka_settings.get("bootstrap.servers"),
            group_id=rdkafka_settings.get("group.id"),
            auto_offset_reset=rdkafka_settings.get("auto.offset.reset", "earliest"),
            **sec,
        )
        return ("kafka-python", consumer)
    except ImportError:
        pass
    raise ImportError(
        "pw.io.kafka requires confluent_kafka or kafka-python to be installed"
    )


class _Msg:
    """Normalized message view over fake tuples and real client objects."""

    __slots__ = ("key", "value", "topic", "partition", "offset", "timestamp_ms")

    def __init__(self, key, value, topic=None, partition=None, offset=None, timestamp_ms=None):
        self.key = key
        self.value = value
        self.topic = topic
        self.partition = partition
        self.offset = offset
        self.timestamp_ms = timestamp_ms


def _normalize_fake(i: int, m) -> _Msg:
    if isinstance(m, dict):
        return _Msg(
            m.get("key"),
            m.get("value"),
            m.get("topic"),
            m.get("partition", 0),
            m.get("offset", i),
            m.get("timestamp_ms"),
        )
    parts = tuple(m)
    key, value = parts[0], parts[1]
    topic = parts[2] if len(parts) > 2 else None
    partition = parts[3] if len(parts) > 3 else 0
    offset = parts[4] if len(parts) > 4 else i
    ts = parts[5] if len(parts) > 5 else None
    return _Msg(key, value, topic, partition, offset, ts)


def _json_pointer(doc, pointer: str):
    """RFC 6901 JSON Pointer lookup (reference json_field_paths)."""
    if pointer in ("", None):
        return doc
    cur = doc
    for tok in pointer.lstrip("/").split("/"):
        tok = tok.replace("~1", "/").replace("~0", "~")
        if isinstance(cur, list):
            # RFC 6901: only unsigned decimal tokens index arrays; any
            # malformed token resolves to None (and must not kill the
            # reader thread)
            if not tok.isdigit():
                return None
            try:
                cur = cur[int(tok)]
            except IndexError:
                return None
        elif isinstance(cur, dict):
            cur = cur.get(tok)
        else:
            return None
        if cur is None:
            return None
    return cur


def read(
    rdkafka_settings: dict,
    topic: str | list[str] | None = None,
    *,
    schema: type[Schema] | None = None,
    format: str = "json",
    autocommit_duration_ms: int | None = 1500,
    json_field_paths: dict[str, str] | None = None,
    autogenerate_key: bool = False,
    with_metadata: bool = False,
    start_from_timestamp_ms: int | None = None,
    name: str = "kafka",
    parallel_readers: bool = False,
    persistent_id: str | None = None,
    retry_policy=None,
    _consumer=None,
    **kwargs,
) -> Table:
    """Stream Kafka topic(s) — reference surface
    (upstream Pathway's python/pathway/io/kafka/__init__.py:27):

    - ``format``: "raw" (bytes), "plaintext" (utf-8 str), or "json"
      (payload parsed into schema columns).
    - ``topic`` may be a single name or a list (real consumers
      subscribe to all; fakes carrying a topic field are filtered).
    - ``json_field_paths``: column -> RFC 6901 JSON Pointer into the
      payload (``{"rating": "/pet/ratings/0"}``).
    - ``autogenerate_key``: for raw/plaintext, synthesize keys instead
      of using the message key.
    - ``with_metadata``: adds a ``_metadata`` JSON column with
      ``topic``/``partition``/``offset``/``timestamp_millis``.
    - ``start_from_timestamp_ms``: start at the given UNIX millis —
      confluent consumers SEEK via offsets_for_times on assignment;
      other paths filter client-side, and messages without a broker
      timestamp pass through.
    - ``parallel_readers``: in a multi-process run every process reads
      its own partition share (graph.rs:943-950) — consumer groups for
      real clients, round-robin for the injected fake.

    ``retry_policy``: a :class:`~pathway_tpu_torch.resilience.RetryPolicy` —
    transient poller exceptions restart the reader with backoff instead
    of failing the run (attempt counts on ``/metrics``).

    ``_consumer`` injects a fake: an iterable of (key, value[, topic,
    partition, offset, timestamp_ms]) tuples or dicts."""
    topics = [topic] if isinstance(topic, str) or topic is None else list(topic)
    if schema is None:
        if format == "raw":
            cols = {"data": ColumnDefinition(dtype=dt.BYTES)}
        elif format == "plaintext":
            cols = {"data": ColumnDefinition(dtype=dt.STR)}
        else:
            raise ValueError("kafka.read requires schema= for json format")
        if with_metadata:
            cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
        schema = schema_builder(cols, name="KafkaRaw")
    elif with_metadata and "_metadata" not in schema.column_names():
        cols = dict(schema.columns())
        cols["_metadata"] = ColumnDefinition(dtype=dt.JSON)
        schema = schema_builder(cols, name=schema.__name__)

    wanted_topics = {t for t in topics if t is not None}

    def emit(ctx: StreamingContext, msg: _Msg) -> None:
        if wanted_topics and msg.topic is not None and msg.topic not in wanted_topics:
            return
        if (
            start_from_timestamp_ms is not None
            and msg.timestamp_ms is not None
            and msg.timestamp_ms < start_from_timestamp_ms
        ):
            return
        _emit(
            ctx,
            msg,
            format,
            schema,
            json_field_paths=json_field_paths,
            with_metadata=with_metadata,
            autogenerate_key=autogenerate_key,
        )

    def reader(ctx: StreamingContext) -> None:
        if _consumer is not None:
            for i, raw in enumerate(_consumer):
                if (
                    parallel_readers
                    and ctx.n_processes > 1
                    and i % ctx.n_processes != ctx.process_id
                ):
                    continue  # another process owns this partition slice
                emit(ctx, _normalize_fake(i, raw))
            ctx.commit()
            return
        kind, consumer = _get_consumer(
            rdkafka_settings,
            [t for t in topics if t is not None],
            start_from_timestamp_ms,
        )
        try:
            if kind == "confluent":
                while not ctx.wait_stopped(0):
                    msg = consumer.poll(timeout=1.0)
                    if msg is None:
                        ctx.commit()
                        continue
                    if msg.error():
                        continue
                    ts = msg.timestamp()
                    emit(
                        ctx,
                        _Msg(
                            msg.key(),
                            msg.value(),
                            msg.topic(),
                            msg.partition(),
                            msg.offset(),
                            ts[1] if ts and ts[0] else None,
                        ),
                    )
            else:
                for msg in consumer:
                    emit(
                        ctx,
                        _Msg(
                            msg.key,
                            msg.value,
                            msg.topic,
                            msg.partition,
                            msg.offset,
                            getattr(msg, "timestamp", None),
                        ),
                    )
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
        parallel_readers=parallel_readers,
        persistent_id=persistent_id,
        retry_policy=retry_policy,
    )


def read_from_upstash(
    endpoint: str,
    username: str,
    password: str,
    topic: str,
    **kwargs,
) -> Table:
    """Upstash-hosted Kafka (reference kafka/__init__.py:396): SASL
    over TLS with the given credentials."""
    settings = {
        "bootstrap.servers": endpoint,
        "security.protocol": "SASL_SSL",
        "sasl.mechanism": "SCRAM-SHA-256",
        "sasl.username": username,
        "sasl.password": password,
        "group.id": kwargs.pop("group_id", "pathway-upstash"),
        "auto.offset.reset": "earliest",
    }
    return read(settings, topic, **kwargs)


def _emit(
    ctx: StreamingContext,
    msg: _Msg,
    format: str,
    schema,
    *,
    json_field_paths: dict[str, str] | None = None,
    with_metadata: bool = False,
    autogenerate_key: bool = False,
) -> None:
    from ..engine.value import Json as _Json

    payload = msg.value
    if payload is None:
        # Kafka tombstone: delete the keyed row (compacted-topic
        # semantics); without a key there is nothing to delete
        if format in ("raw", "plaintext") and not autogenerate_key and msg.key is not None:
            key = msg.key if isinstance(msg.key, bytes) else str(msg.key).encode()
            ctx.upsert_keyed((key,), None)
        return
    if format == "raw":
        rec = {"data": payload if isinstance(payload, bytes) else str(payload).encode()}
    elif format == "plaintext":
        rec = {
            "data": payload.decode(errors="replace")
            if isinstance(payload, bytes)
            else str(payload)
        }
    else:
        try:
            doc = json.loads(payload)
        except (ValueError, TypeError):
            return
        if json_field_paths:
            rec = dict(doc) if isinstance(doc, dict) else {}
            for col, pointer in json_field_paths.items():
                rec[col] = _json_pointer(doc, pointer)
        else:
            rec = doc if isinstance(doc, dict) else {}
    if with_metadata:
        meta = {
            "topic": msg.topic,
            "partition": msg.partition,
            "offset": msg.offset,
        }
        if msg.timestamp_ms is not None:
            meta["timestamp_millis"] = msg.timestamp_ms
        rec["_metadata"] = _Json(meta)
    if format in ("raw", "plaintext") and not autogenerate_key and msg.key is not None:
        key = msg.key if isinstance(msg.key, bytes) else str(msg.key).encode()
        ctx.upsert_keyed((key,), rec)
    else:
        ctx.insert(rec)


def write(
    table: Table,
    rdkafka_settings: dict,
    topic_name: str | None = None,
    *,
    format: str = "json",
    name: str = "kafka.write",
    _producer=None,
    **kwargs,
) -> None:
    """``_producer`` injects a fake for tests: an object with
    produce(topic, payload)."""
    producer_holder: list = []

    def get_producer():
        if producer_holder:
            return producer_holder[0]
        if _producer is not None:
            producer_holder.append(("confluent", _producer))
            return producer_holder[0]
        try:
            from confluent_kafka import Producer  # type: ignore

            p = ("confluent", Producer(rdkafka_settings))
        except ImportError:
            from kafka import KafkaProducer  # type: ignore

            p = (
                "kafka-python",
                KafkaProducer(
                    bootstrap_servers=rdkafka_settings.get("bootstrap.servers")
                ),
            )
        producer_holder.append(p)
        return p

    names = table.column_names()

    def on_change(key, row, time_, diff):
        kind, producer = get_producer()
        from .fs import _jsonable

        rec = {n: _jsonable(row[n]) for n in names}
        rec["time"] = time_
        rec["diff"] = diff
        payload = json.dumps(rec).encode()
        if kind == "confluent":
            producer.produce(topic_name, payload)
            producer.poll(0)
        else:
            producer.send(topic_name, payload)

    add_output_sink(table, on_change, name=name)


def simple_read(
    server: str,
    topic: str,
    *,
    read_only_new: bool = False,
    schema: type[Schema] | None = None,
    format: str = "raw",
    autocommit_duration_ms: int | None = 1500,
    json_field_paths: dict[str, str] | None = None,
    parallel_readers: bool = False,
    persistent_id: str | None = None,
    _consumer=None,
) -> Table:
    """Minimal-config Kafka read (reference io/kafka simple_read :299):
    just a bootstrap server and topic, anonymous group, starting from
    the beginning of the topic unless ``read_only_new``. For
    authentication or tuning, use :func:`read`."""
    import uuid

    # each call gets its own anonymous consumer group (fresh uuid): two
    # simple_reads over one topic each see the FULL topic, and reruns
    # never inherit a previous run's committed offsets. The flip side:
    # partition-sharing across a multi-process cluster needs one SHARED
    # group, which an anonymous group cannot provide — that combination
    # is refused rather than silently ingesting every record per
    # process (the reference's simple_read has that silent behavior).
    if parallel_readers:
        raise ValueError(
            "kafka.simple_read cannot shard partitions across processes "
            "with an anonymous consumer group; use pw.io.kafka.read with "
            "an explicit rdkafka 'group.id' shared by the cluster"
        )
    rdkafka_settings = {
        "bootstrap.servers": server,
        "group.id": f"pathway-simple-{uuid.uuid4().hex[:12]}",
        "auto.offset.reset": "latest" if read_only_new else "earliest",
    }
    return read(
        rdkafka_settings,
        topic,
        schema=schema,
        format=format,
        autocommit_duration_ms=autocommit_duration_ms,
        json_field_paths=json_field_paths,
        parallel_readers=parallel_readers,
        persistent_id=persistent_id,
        name="kafka.simple",
        _consumer=_consumer,
    )
