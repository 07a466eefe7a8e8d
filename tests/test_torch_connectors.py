"""The port's message and database connectors held against the JAX package's, on the CPU.

The slice's cases of ``tests/test_connector_clients.py`` and
``tests/test_connector_matrix_r4.py``, each run on both packages through the
same injected fakes: Kafka read and write, its formats, JSON pointers,
metadata, the timestamp filter and Upstash's settings; Postgres updates and
snapshots; Debezium's postgres, mongodb and keyless envelopes and
tombstones; NATS; ElasticSearch, MongoDB, BigQuery, Pub/Sub, Logstash and
Slack sinks; the DSV, JSON Lines, psql and BSON formats; SQLite on a real
temporary database. Then what the reference's own tests leave out:
``_get_consumer``'s confluent branch against ``chip_smoke.py``'s in-process
broker in ``sys.modules`` (the seek on assignment, its fallbacks, a run
through the branch's poll loop, the confluent producer), its kafka-python
branch with the SASL mapping, the ``ImportError`` without a client,
``parallel_readers``' share of each process at two processes, and a
``persistent_id`` restart. A case on the port also runs the scenario on the
reference and requires equal results.
"""

from __future__ import annotations

import importlib
import json
import os
import sqlite3
import sys
import threading
import time
import types

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import KafkaStandIn  # noqa: E402

PACKAGES = {"reference": jpw, "port": tpw}


@pytest.fixture(params=sorted(PACKAGES))
def pw(request):
    pkg = PACKAGES[request.param]
    jpw.clear_graph()
    tpw.clear_graph()
    yield pkg
    jpw.clear_graph()
    tpw.clear_graph()


def _same(pw, scenario):
    """``scenario(pw)``; on the port also ``scenario(reference)``, which must be equal."""
    got = scenario(pw)
    pw.clear_graph()
    if pw is tpw:
        want = scenario(jpw)
        jpw.clear_graph()
        assert got == want
    return got


def _mod(pw, name: str):
    return importlib.import_module(f"{pw.__name__}.{name}")


def _kv(pw):
    class KV(pw.Schema):
        k: str
        v: int

    return KV


def _run(pw, table) -> tuple:
    runner = _mod(pw, "internals.graph_runner").GraphRunner()
    cap, names = runner.capture(table)
    runner.run()
    pw.clear_graph()
    return cap, names


def _rows(pw, table, *cols) -> list:
    cap, names = _run(pw, table)
    idx = [names.index(c) for c in cols]
    return sorted(tuple(row[i] for i in idx) for row in cap.state.values())


def _run_outputs(pw) -> None:
    """Run the sinks registered in the package's graph to completion."""
    runner = _mod(pw, "internals.graph_runner").GraphRunner()
    for table, sink in list(_mod(pw, "internals.parse_graph").G.outputs):
        sink["build"](runner, table)
    runner.run()
    pw.clear_graph()


def _collect(pw, table) -> list:
    rows = []
    pw.io.subscribe(table, on_change=lambda key, row, time, is_addition: rows.append(row))
    pw.run(monitoring_level="none")
    pw.clear_graph()
    return rows


def _stand_in(monkeypatch, idle_s: float = 0.05) -> KafkaStandIn:
    """``chip_smoke.py``'s broker as ``confluent_kafka``; an idle poll here
    returns after ``idle_s`` (the readers poll with a 1 s timeout)."""
    broker = KafkaStandIn()
    poll = broker.module.Consumer.poll
    broker.module.Consumer.poll = lambda self, timeout=None: poll(self, min(timeout, idle_s))
    monkeypatch.setitem(sys.modules, "confluent_kafka", broker.module)
    return broker


def _run_until(pw, table, broker, done, timeout: float = 60.0) -> dict:
    """Run a streaming table and the graph's sinks on a thread until
    ``done(state)`` holds, then stop the engine and the broker -> the
    captured {key: row}."""
    runner = _mod(pw, "internals.graph_runner").GraphRunner()
    for sink_table, sink in list(_mod(pw, "internals.parse_graph").G.outputs):
        sink["build"](runner, sink_table)
    cap, names = runner.capture(table)
    errors = []

    def run():
        try:
            runner.run()
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.monotonic() + timeout
    while not done(cap.state) and not errors and time.monotonic() < deadline:
        time.sleep(0.01)
    runner.engine.stop()
    broker.shutdown()
    th.join(timeout=30)
    pw.clear_graph()
    assert not th.is_alive() and not errors, errors
    return {key: dict(zip(names, row)) for key, row in cap.state.items()}


# ------------------------------------------------------------------- kafka


def test_kafka_read_with_fake_consumer(pw):
    def scenario(pw):
        msgs = [(None, json.dumps({"k": w, "v": i}).encode()) for i, w in enumerate("abc")]
        return _rows(pw, pw.io.kafka.read({}, "topic", schema=_kv(pw), _consumer=iter(msgs)), "k", "v")

    assert _same(pw, scenario) == [("a", 0), ("b", 1), ("c", 2)]


def test_kafka_write_with_fake_producer(pw):
    def scenario(pw):
        class FakeProducer:
            def __init__(self):
                self.sent = []

            def produce(self, topic, payload):
                self.sent.append((topic, payload))

            def poll(self, timeout):
                pass

        prod = FakeProducer()
        t = pw.debug.table_from_rows(schema=_kv(pw), rows=[("x", 1), ("y", 2)])
        pw.io.kafka.write(t, {}, "out-topic", _producer=prod)
        _run_outputs(pw)
        return sorted((topic, json.loads(p)["k"], json.loads(p)["v"], json.loads(p)["diff"]) for topic, p in prod.sent)

    assert _same(pw, scenario) == [("out-topic", "x", 1, 1), ("out-topic", "y", 2, 1)]


def test_kafka_formats_and_json_pointers(pw):
    def scenario(pw):
        msgs = [
            (None, json.dumps({"pet": {"name": "rex", "ratings": [9, 7]}}).encode()),
            (None, json.dumps({"pet": {"name": "ada", "ratings": [10]}}).encode()),
            (None, b"not json"),
        ]

        class S(pw.Schema):
            name: str
            rating: int

        pointers = pw.io.kafka.read({}, "pets", schema=S, format="json",
                                    json_field_paths={"name": "/pet/name", "rating": "/pet/ratings/0"}, _consumer=msgs)
        got = [_rows(pw, pointers, "name", "rating")]
        keyed = [(b"k1", b"first"), (b"k2", b"other"), (b"k1", b"second")]
        got.append(_rows(pw, pw.io.kafka.read({}, "t", format="plaintext", _consumer=keyed), "data"))
        got.append(len(_rows(pw, pw.io.kafka.read({}, "t", format="plaintext", autogenerate_key=True,
                                                  _consumer=keyed), "data")))
        got.append(_rows(pw, pw.io.kafka.read({}, "t", format="raw", _consumer=[(b"k", b"\x00\x01")]), "data"))
        # a tombstone (null value) deletes its key's row
        got.append(_rows(pw, pw.io.kafka.read({}, "t", format="plaintext", _consumer=keyed + [(b"k2", None)]), "data"))
        return got

    assert _same(pw, scenario) == [
        [("ada", 10), ("rex", 9)], [("other",), ("second",)], 3, [(b"\x00\x01",)], [("second",)],
    ]


@pytest.mark.parametrize("pointer,want", [("/a/b", 1), ("/list/1", "y"), ("/list/x", None), ("/list/9", None),
                                          ("/a~1b", 2), ("/t~0", 3), ("", "doc"), ("/missing/deeper", None)])
def test_kafka_json_pointer(pw, pointer, want):
    doc = {"a": {"b": 1}, "list": ["x", "y"], "a/b": 2, "t~": 3}
    got = _mod(pw, "io.kafka")._json_pointer(doc, pointer)
    assert (doc if want == "doc" else want) == got


def test_kafka_metadata_topics_and_timestamp_filter(pw):
    def scenario(pw):
        msgs = [
            {"key": b"a", "value": b"x", "topic": "keep", "partition": 2, "offset": 5, "timestamp_ms": 1000},
            {"key": b"b", "value": b"y", "topic": "drop", "timestamp_ms": 2000},
            {"key": b"c", "value": b"z", "topic": "keep", "timestamp_ms": 500},
            (b"d", b"w", "keep", 1, 7, 1500),
        ]
        t = pw.io.kafka.read({}, ["keep"], format="plaintext", with_metadata=True, start_from_timestamp_ms=900,
                             _consumer=msgs)
        return sorted((row["data"], json.dumps(row["_metadata"].value, sort_keys=True)) for row in _collect(pw, t))

    assert _same(pw, scenario) == [
        ("w", json.dumps({"offset": 7, "partition": 1, "timestamp_millis": 1500, "topic": "keep"}, sort_keys=True)),
        ("x", json.dumps({"offset": 5, "partition": 2, "timestamp_millis": 1000, "topic": "keep"}, sort_keys=True)),
    ]


def test_kafka_read_from_upstash_and_simple_read(pw):
    def scenario(pw):
        t = pw.io.kafka.read_from_upstash("ep:9092", "user", "pass", "topic", format="plaintext",
                                          autogenerate_key=True, _consumer=[(None, b"hello")])
        got = [_rows(pw, t, "data")]
        got.append(_rows(pw, pw.io.kafka.simple_read("localhost:9092", "t", _consumer=[(b"k", b"raw")]), "data"))
        with pytest.raises(ValueError, match="anonymous consumer group"):
            pw.io.kafka.simple_read("localhost:9092", "t", parallel_readers=True, _consumer=[])
        return got

    assert _same(pw, scenario) == [[("hello",)], [(b"raw",)]]


def test_kafka_json_without_schema_raises_and_redpanda_is_kafka(pw):
    with pytest.raises(ValueError, match="requires schema="):
        pw.io.kafka.read({}, "t", format="json", _consumer=[])
    assert pw.io.redpanda.read is pw.io.kafka.read and pw.io.redpanda.write is pw.io.kafka.write


def _produce_with_times(broker):
    producer = broker.module.Producer({})
    broker.create_topic("t", 2)
    for partition, ts, value in ((0, 1000, b"p0-a"), (0, 2000, b"p0-b"), (1, 500, b"p1-a"), (1, 1200, b"p1-b")):
        producer.produce("t", value, partition=partition, timestamp=ts)


def _drain(consumer) -> list:
    out = []
    while (msg := consumer.poll(timeout=0.01)) is not None:
        out.append((msg.partition(), msg.offset(), msg.value()))
    return out


@pytest.mark.parametrize("case", ["no_timestamp", "seek", "lookup_fails"])
def test_kafka_get_consumer_confluent_branch(pw, monkeypatch, case):
    """``_get_consumer`` subscribes a confluent consumer; with a start
    timestamp its ``on_assign`` seeks each partition through
    ``offsets_for_times`` (a partition with no record at or after it starts
    at its end), and keeps the original assignment when the lookup fails."""

    def scenario(pw):
        broker = _stand_in(monkeypatch)
        _produce_with_times(broker)
        if case == "lookup_fails":
            def fail(self, partitions, timeout=None):
                raise broker.module.KafkaException("lookup timed out")

            monkeypatch.setattr(broker.module.Consumer, "offsets_for_times", fail)
        settings = {"bootstrap.servers": "b:9092", "group.id": "g", "auto.offset.reset": "earliest"}
        kind, consumer = _mod(pw, "io.kafka")._get_consumer(settings, "t", None if case == "no_timestamp" else 1500)
        got = (kind, sorted(_drain(consumer)), broker.subscriptions, broker.calls["offsets_for_times"],
               broker.calls["assign"])
        consumer.close()
        return got

    all_four = [(0, 0, b"p0-a"), (0, 1, b"p0-b"), (1, 0, b"p1-a"), (1, 1, b"p1-b")]
    want = {
        "no_timestamp": ("confluent", all_four, [["t"]], 0, 1),
        "seek": ("confluent", [(0, 1, b"p0-b")], [["t"]], 1, 1),
        "lookup_fails": ("confluent", all_four, [["t"]], 0, 1),
    }[case]
    assert _same(pw, scenario) == want


def test_kafka_read_and_write_through_the_confluent_branch(pw, monkeypatch):
    """No injected client: ``pw.io.kafka.read`` polls the stand-in's consumer
    (keyed plaintext records upsert, a tombstone deletes) and
    ``pw.io.kafka.write`` produces through its ``Producer``."""

    def scenario(pw):
        broker = _stand_in(monkeypatch)
        broker.create_topic("in", 2)
        broker.produce_many("in", [(b"a", b"1"), (b"b", b"2"), (b"a", b"3"), (b"c", b"4"), (b"c", None)])
        t = pw.io.kafka.read({"group.id": "g", "auto.offset.reset": "earliest"}, "in", format="plaintext")
        pw.io.kafka.write(t, {"bootstrap.servers": "b:9092"}, "out")
        state = _run_until(pw, t, broker, lambda s: sorted(r[0] for r in s.values()) == ["2", "3"])
        written = sorted((json.loads(v)["data"], json.loads(v)["diff"]) for _k, v, _ts in broker.records("out"))
        return sorted(r["data"] for r in state.values()), written, broker.calls["subscribe"], broker.calls["Producer"]

    data, written, subscribes, producers = _same(pw, scenario)
    assert data == ["2", "3"] and subscribes == 1 and producers == 1
    # every change reached the sink: "3" replaced "1" and "c" came and went, in whichever epochs the polls cut
    assert {d for d, diff in written if diff == 1} >= {"2", "3"}
    assert sum(diff for _d, diff in written) == 2


def test_kafka_python_branch_maps_sasl_settings(pw, monkeypatch):
    def scenario(pw):
        seen = {}

        class Msg:
            def __init__(self, i):
                self.key, self.value, self.topic, self.partition, self.offset = None, json.dumps(
                    {"k": f"r{i}", "v": i}).encode(), "t", 0, i
                self.timestamp = 1000 + i

        class KafkaConsumer:
            def __init__(self, *topics, **kw):
                seen["topics"], seen["kw"] = topics, kw

            def __iter__(self):
                return iter([Msg(0), Msg(1)])

            def close(self):
                seen["closed"] = True

        mod = types.ModuleType("kafka")
        mod.KafkaConsumer = KafkaConsumer
        monkeypatch.setitem(sys.modules, "confluent_kafka", None)
        monkeypatch.setitem(sys.modules, "kafka", mod)
        settings = {"bootstrap.servers": "b:9092", "group.id": "g", "security.protocol": "SASL_SSL",
                    "sasl.mechanisms": "PLAIN", "sasl.username": "u", "sasl.password": "p"}
        rows = _rows(pw, pw.io.kafka.read(settings, "t", schema=_kv(pw)), "k", "v")
        return rows, seen

    rows, seen = _same(pw, scenario)
    assert rows == [("r0", 0), ("r1", 1)] and seen["topics"] == ("t",) and seen["closed"]
    assert seen["kw"] == {"bootstrap_servers": "b:9092", "group_id": "g", "auto_offset_reset": "earliest",
                          "security_protocol": "SASL_SSL", "sasl_mechanism": "PLAIN", "sasl_plain_username": "u",
                          "sasl_plain_password": "p"}


def test_kafka_without_a_client_raises_import_error(pw, monkeypatch):
    monkeypatch.setitem(sys.modules, "confluent_kafka", None)
    monkeypatch.setitem(sys.modules, "kafka", None)
    with pytest.raises(ImportError, match="requires confluent_kafka or kafka-python"):
        _mod(pw, "io.kafka")._get_consumer({}, "t")


@pytest.mark.parametrize("process_id", [0, 1])
def test_kafka_parallel_readers_take_their_share(pw, monkeypatch, process_id):
    """At two processes each reader keeps every second record of the
    injected consumer, its own partition share."""

    def scenario(pw):
        conn = _mod(pw, "io._connector")
        real = conn.StreamingContext.__init__

        def as_process(self, *a, **kw):
            real(self, *a, **kw)
            self.process_id, self.n_processes = process_id, 2

        monkeypatch.setattr(conn.StreamingContext, "__init__", as_process)
        msgs = [(None, json.dumps({"k": f"r{i}", "v": i}).encode()) for i in range(7)]
        shared = _rows(pw, pw.io.kafka.read({}, "t", schema=_kv(pw), parallel_readers=True, _consumer=msgs), "v")
        whole = _rows(pw, pw.io.kafka.read({}, "t", schema=_kv(pw), _consumer=msgs), "v")
        monkeypatch.setattr(conn.StreamingContext, "__init__", real)
        return shared, whole

    shared, whole = _same(pw, scenario)
    assert shared == [(v,) for v in range(process_id, 7, 2)] and whole == [(v,) for v in range(7)]


def test_kafka_persistent_id_restart(pw, tmp_path):
    """A persisted Kafka source restarted over the same topic. The reader
    keeps no offsets, so each run reads the topic again from its start; the
    restart resets the source's log, so a run's sinks see each record once,
    never a second copy beside the recovered one."""

    def scenario(pw):
        backend = pw.persistence.Backend.filesystem(str(tmp_path / pw.__name__))
        msgs = [(None, json.dumps({"k": w, "v": i}).encode()) for i, w in enumerate("abc")]

        def run(consumer):
            events = []
            t = pw.io.kafka.read({}, "t", schema=_kv(pw), persistent_id="kafka-t", _consumer=consumer)
            pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: events.append((row["k"], is_addition)))
            pw.run(monitoring_level="none", persistence_config=pw.persistence.Config.simple_config(backend))
            pw.clear_graph()
            return sorted(events)

        return run(list(msgs)), run(list(msgs)), run(msgs + [(None, json.dumps({"k": "d", "v": 3}).encode())])

    first, second, third = _same(pw, scenario)
    assert first == second == [("a", True), ("b", True), ("c", True)]
    assert third == first + [("d", True)]


# ------------------------------------------------------------- postgres


class FakePg:
    def __init__(self):
        self.executed: list = []
        self.commits = 0
        self.closed = False

    def cursor(self):
        pg = self

        class Cur:
            def execute(self, sql, params):
                pg.executed.append((sql, tuple(params)))

            def close(self):
                pass

        return Cur()

    def commit(self):
        self.commits += 1

    def close(self):
        self.closed = True


def test_postgres_write_updates(pw):
    def scenario(pw):
        pg = FakePg()
        t = pw.debug.table_from_rows(schema=_kv(pw), rows=[("x", 1), ("y", 2)])
        pw.io.postgres.write(t, {"host": "h"}, "tbl", _connection_factory=lambda s: pg)
        _run_outputs(pw)
        return sorted(pg.executed), pg.commits >= 1, pg.closed

    executed, committed, closed = _same(pw, scenario)
    assert [params for _sql, params in executed] == [("x", 1), ("y", 2)] and committed and closed
    assert all(sql.startswith("INSERT INTO tbl (k,v,time,diff) VALUES (%s,%s,") for sql, _p in executed)


def test_postgres_write_snapshot_upsert_and_delete(pw):
    def scenario(pw):
        pg = FakePg()
        t = pw.debug.table_from_markdown(
            """
              | k | v | __time__ | __diff__
            1 | x | 1 | 0        | 1
            1 | x | 1 | 2        | -1
            1 | x | 5 | 2        | 1
            """
        )
        pw.io.postgres.write_snapshot(t, {"host": "h"}, "snap", ["k"], max_batch_size=1,
                                      _connection_factory=lambda s: pg)
        _run_outputs(pw)
        return pg.executed, pg.commits

    executed, commits = _same(pw, scenario)
    inserts = [e for e in executed if e[0].startswith("INSERT")]
    deletes = [e for e in executed if e[0].startswith("DELETE")]
    assert all("ON CONFLICT (k) DO UPDATE SET v=EXCLUDED.v" in sql for sql, _ in inserts) and len(inserts) == 2
    assert deletes and deletes[0][1] == ("x",) and commits >= len(executed)


def test_postgres_read_raises_and_connects_through_psycopg2(pw, monkeypatch):
    with pytest.raises(NotImplementedError, match="debezium"):
        pw.io.postgres.read({}, "t")
    made = []
    mod = types.ModuleType("psycopg2")
    mod.connect = lambda dsn: made.append(dsn) or FakePg()
    monkeypatch.setitem(sys.modules, "psycopg2", mod)
    conn = _mod(pw, "io.postgres")._default_connection_factory({"host": "h", "dbname": "d"})
    assert isinstance(conn, FakePg) and made == ["host=h dbname=d"]
    monkeypatch.setitem(sys.modules, "psycopg2", None)
    with pytest.raises(ImportError, match="psycopg2"):
        _mod(pw, "io.postgres")._default_connection_factory({})


# ------------------------------------------------------------- debezium


def _dbz(op, before=None, after=None, key=None):
    value = json.dumps({"payload": {"op": op, "before": before, "after": after}})
    kp = json.dumps({"payload": key}) if key is not None else None
    return (kp, value)


def test_debezium_postgres_inserts_updates_deletes(pw):
    def scenario(pw):
        msgs = [
            _dbz("r", after={"k": "x", "v": 1}, key={"k": "x"}),
            _dbz("c", after={"k": "y", "v": 2}, key={"k": "y"}),
            _dbz("u", before={"k": "x", "v": 1}, after={"k": "x", "v": 7}, key={"k": "x"}),
            _dbz("d", before={"k": "y", "v": 2}, key={"k": "y"}),
            (json.dumps({"payload": {"k": "y"}}), None),  # the tombstone after a delete
        ]
        return _rows(pw, pw.io.debezium.read({}, "cdc", schema=_kv(pw), _consumer=iter(msgs)), "k", "v")

    assert _same(pw, scenario) == [("x", 7)]


def test_debezium_keyless_postgres_keeps_multiplicity(pw):
    """Without a key payload two identical inserts are two rows and one
    delete removes one of them."""

    def scenario(pw):
        row = {"k": "x", "v": 1}
        msgs = [_dbz("c", after=row), _dbz("c", after=row), _dbz("c", after={"k": "y", "v": 2}),
                _dbz("d", before=row), _dbz("u", before={"k": "y", "v": 2}, after={"k": "y", "v": 3})]
        return _rows(pw, pw.io.debezium.read({}, "cdc", schema=_kv(pw), _consumer=msgs), "k", "v")

    assert _same(pw, scenario) == [("x", 1), ("y", 3)]


def test_debezium_mongodb_upserts(pw):
    def scenario(pw):
        msgs = [
            _dbz("r", after=json.dumps({"k": "x", "v": 1}), key={"id": "1"}),
            _dbz("u", after=json.dumps({"k": "x", "v": 9}), key={"id": "1"}),
            _dbz("r", after=json.dumps({"k": "z", "v": 3}), key={"id": "2"}),
            _dbz("d", key={"id": "2"}),
        ]
        t = pw.io.debezium.read({}, "cdc", schema=_kv(pw), db_type="mongodb", _consumer=iter(msgs))
        return _rows(pw, t, "k", "v")

    assert _same(pw, scenario) == [("x", 9)]


def test_debezium_mongodb_without_a_key_raises(pw):
    msgs = [_dbz("u", after=json.dumps({"k": "x", "v": 9}))]
    t = pw.io.debezium.read({}, "cdc", schema=_kv(pw), db_type="mongodb", _consumer=msgs)
    with pytest.raises(Exception) as info:
        _run(pw, t)
    pw.clear_graph()
    chain = [info.value] + [e for e in (info.value.__cause__, info.value.__context__) if e is not None]
    assert any("need a key payload" in str(e) for e in chain)


def test_debezium_parser_tombstones_and_errors(pw):
    p = _mod(pw, "io._formats").DebeziumMessageParser()
    assert p.parse(None, None) == [] and p.parse(None, "null") == []
    with pytest.raises(ValueError, match="no payload"):
        p.parse(None, json.dumps({"schema": {}}))
    with pytest.raises(ValueError, match="unknown debezium op"):
        p.parse(None, json.dumps({"payload": {"op": "t"}}))
    assert p.session_type == "native"
    assert _mod(pw, "io._formats").DebeziumMessageParser(db_type="mongodb").session_type == "upsert"
    assert p.parse(b'{"payload": {"id": 4}}', b'{"payload": {"op": "c", "after": {"a": 1}}}') == [
        ("insert", {"a": 1}, {"id": 4})]


# ----------------------------------------------------------------- nats


def test_nats_read_and_write(pw):
    def scenario(pw):
        payloads = [json.dumps({"k": w, "v": i}).encode() for i, w in enumerate("pq")] + [b"not json"]
        got = [_rows(pw, pw.io.nats.read("nats://x", "subj", schema=_kv(pw), _subscription=iter(payloads)), "k")]
        got.append(_rows(pw, pw.io.nats.read("nats://x", "subj", format="raw", _subscription=[b"\x01"]), "data"))

        class FakePub:
            def __init__(self):
                self.published, self.closed = [], False

            def publish(self, subject, payload):
                self.published.append((subject, json.loads(payload)))

            def close(self):
                self.closed = True

        pub = FakePub()
        pw.io.nats.write(pw.debug.table_from_rows(schema=_kv(pw), rows=[("a", 1)]), "nats://x", "out",
                         _publisher=pub)
        _run_outputs(pw)
        got.append([(s, p["k"], p["v"], p["diff"]) for s, p in pub.published] + [pub.closed])
        return got

    assert _same(pw, scenario) == [[("p",), ("q",)], [(b"\x01",)], [("out", "a", 1, 1), True]]


def test_nats_without_nats_py_raises(pw, monkeypatch):
    monkeypatch.setitem(sys.modules, "nats", None)
    with pytest.raises(ImportError, match="nats-py"):
        _mod(pw, "io.nats")._run_async_subscriber("nats://x", "s", print)


# ------------------------------------------ sinks: es, mongodb, bq, pubsub, logstash, slack


def test_elasticsearch_write(pw):
    def scenario(pw):
        class FakeES:
            def __init__(self):
                self.docs, self.closed = [], False

            def index(self, index, document):
                self.docs.append((index, document["k"], document["v"], document["diff"]))

            def close(self):
                self.closed = True

        es = FakeES()
        t = pw.debug.table_from_rows(schema=_kv(pw), rows=[("x", 1), ("y", 2)])
        pw.io.elasticsearch.write(t, "http://localhost", None, "idx", _client=es)
        _run_outputs(pw)
        return sorted(es.docs), es.closed

    assert _same(pw, scenario) == ([("idx", "x", 1, 1), ("idx", "y", 2, 1)], True)


def test_elasticsearch_auth_and_client(pw, monkeypatch):
    es = _mod(pw, "io.elasticsearch")
    assert es.ElasticSearchAuth.basic("u", "p").as_client_kwargs() == {"basic_auth": ("u", "p")}
    assert es.ElasticSearchAuth.apikey("key", "id").as_client_kwargs() == {"api_key": ("id", "key")}
    assert es.ElasticSearchAuth.apikey("key").as_client_kwargs() == {"api_key": "key"}
    assert es.ElasticSearchAuth.bearer("tok").as_client_kwargs() == {"bearer_auth": "tok"}
    made = []

    class Elasticsearch:
        def __init__(self, host, **kw):
            made.append((host, kw))

        def index(self, index, document):
            made.append((index, document["a"]))

    mod = types.ModuleType("elasticsearch")
    mod.Elasticsearch = Elasticsearch
    monkeypatch.setitem(sys.modules, "elasticsearch", mod)
    t = pw.debug.table_from_rows(schema=pw.schema_from_types(a=int), rows=[(5,)])
    pw.io.elasticsearch.write(t, "http://es:9200", es.ElasticSearchAuth.bearer("tok"), "idx")
    _run_outputs(pw)
    assert made == [("http://es:9200", {"bearer_auth": "tok"}), ("idx", 5)]


def test_elasticsearch_write_failure_surfaces(pw):
    class ES:
        def index(self, **kw):
            raise ConnectionError("cluster red")

    t = pw.debug.table_from_rows(schema=pw.schema_from_types(a=int), rows=[(1,)])
    pw.io.elasticsearch.write(t, "http://localhost", None, "idx", _client=ES())
    with pytest.raises(Exception):
        pw.run(monitoring_level="none")
    pw.clear_graph()


def test_mongodb_write_batches(pw):
    def scenario(pw):
        class FakeColl:
            def __init__(self):
                self.batches = []

            def insert_many(self, docs):
                self.batches.append([(d["k"], d["v"], d["diff"]) for d in docs])

        coll = FakeColl()
        t = pw.debug.table_from_rows(schema=_kv(pw), rows=[("x", 1), ("y", 2), ("z", 3)])
        pw.io.mongodb.write(t, max_batch_size=2, _collection=coll)
        _run_outputs(pw)
        return sorted(len(b) for b in coll.batches), sorted(d for b in coll.batches for d in b)

    assert _same(pw, scenario) == ([1, 2], [("x", 1, 1), ("y", 2, 1), ("z", 3, 1)])


def test_mongodb_without_pymongo_raises(pw, monkeypatch):
    monkeypatch.setitem(sys.modules, "pymongo", None)
    t = pw.debug.table_from_rows(schema=_kv(pw), rows=[("x", 1)])
    pw.io.mongodb.write(t, connection_string="mongodb://h", database="d", collection="c")
    with pytest.raises(ImportError, match="pymongo"):
        _run_outputs(pw)
    pw.clear_graph()


def test_bigquery_write(pw):
    def scenario(pw):
        class FakeBQ:
            def __init__(self):
                self.rows = []

            def insert_rows_json(self, target, rows):
                self.rows.append((target, sorted((r["k"], r["v"], r["diff"]) for r in rows)))
                return []

        bq = FakeBQ()
        t = pw.debug.table_from_rows(schema=_kv(pw), rows=[("x", 1), ("y", 2), ("z", 3)])
        pw.io.bigquery.write(t, "ds", "tbl", max_batch_size=2, _client=bq)
        _run_outputs(pw)
        return sorted(len(rs) for _t, rs in bq.rows), sorted(r for _t, rs in bq.rows for r in rs), {t for t, _ in bq.rows}

    assert _same(pw, scenario) == ([1, 2], [("x", 1, 1), ("y", 2, 1), ("z", 3, 1)], {"ds.tbl"})


def test_bigquery_insert_errors_raise(pw):
    class FailingBQ:
        def insert_rows_json(self, target, rows):
            return [{"index": 0, "errors": ["bad row"]}]

    pw.io.bigquery.write(pw.debug.table_from_rows(schema=_kv(pw), rows=[("x", 1)]), "ds", "tbl", _client=FailingBQ())
    with pytest.raises(Exception) as info:
        _run_outputs(pw)
    pw.clear_graph()
    assert "bigquery insert failed" in str(info.value) or "bigquery insert failed" in str(info.value.__cause__)


def test_pubsub_write(pw):
    def scenario(pw):
        class FakePublisher:
            def __init__(self):
                self.msgs = []

            def topic_path(self, project, topic):
                return f"projects/{project}/topics/{topic}"

            def publish(self, topic, data, **attrs):
                self.msgs.append((topic, json.loads(data), attrs["pathway_diff"]))

        pub = FakePublisher()
        t = pw.debug.table_from_rows(schema=_kv(pw), rows=[("x", 1)])
        pw.io.pubsub.write(t, project_id="p", topic_id="t", _publisher=pub)
        _run_outputs(pw)
        return pub.msgs

    assert _same(pw, scenario) == [("projects/p/topics/t", {"k": "x", "v": 1}, "1")]


def test_logstash_write_with_retries(pw, monkeypatch):
    def scenario(pw):
        calls, delays = [], []

        def post(endpoint, payload):
            calls.append((endpoint, json.loads(payload)["k"]))
            if len(calls) <= 2:
                raise ConnectionError("transient")

        t = pw.debug.table_from_rows(schema=_kv(pw), rows=[("x", 1)])
        pw.io.logstash.write(t, "http://ls:8080", n_retries=2, retry_policy=lambda attempt: delays.append(attempt) or 0,
                             _post=post)
        _run_outputs(pw)
        return calls, delays

    assert _same(pw, scenario) == ([("http://ls:8080", "x")] * 3, [0, 1])


def test_logstash_gives_up_after_its_retries(pw):
    def post(endpoint, payload):
        raise ConnectionError("down")

    pw.io.logstash.write(pw.debug.table_from_rows(schema=_kv(pw), rows=[("x", 1)]), "http://ls", n_retries=1,
                         _post=post)
    with pytest.raises(Exception):
        _run_outputs(pw)
    pw.clear_graph()


def test_logstash_and_slack_post_through_urllib(pw, monkeypatch):
    """The default posters build the same requests on ``urllib.request``."""
    sent = []

    class Resp:
        def read(self):
            return b"{}"

    def urlopen(req, timeout=None):
        sent.append((req.full_url, req.data, dict(req.header_items()), timeout))
        return Resp()

    monkeypatch.setattr("urllib.request.urlopen", urlopen)
    _mod(pw, "io.logstash")._default_post("http://ls:8080", b'{"a": 1}')
    _mod(pw, "io.slack")._default_post("https://slack.com/api/chat.postMessage", {"text": "hi"}, "tok")
    assert sent == [
        ("http://ls:8080", b'{"a": 1}', {"Content-type": "application/json"}, 30),
        ("https://slack.com/api/chat.postMessage", b'{"text": "hi"}',
         {"Content-type": "application/json", "Authorization": "Bearer tok"}, 30),
    ]


def test_slack_send_alerts(pw):
    def scenario(pw):
        posts = []
        t = pw.debug.table_from_markdown(
            """
              | k      | __time__ | __diff__
            1 | alert! | 0        | 1
            2 | second | 2        | 1
            1 | alert! | 4        | -1
            """
        )
        pw.io.slack.send_alerts(t.k, "C123", "xoxb-token", _post=lambda url, payload, tok: posts.append((url, payload, tok)))
        _run_outputs(pw)
        return posts

    url = "https://slack.com/api/chat.postMessage"
    assert _same(pw, scenario) == [(url, {"channel": "C123", "text": "alert!"}, "xoxb-token"),
                                   (url, {"channel": "C123", "text": "second"}, "xoxb-token")]


# --------------------------------------------------------------- sqlite


def _users_db(path) -> str:
    conn = sqlite3.connect(path)
    conn.execute("CREATE TABLE users (id INTEGER, name TEXT, score REAL)")
    conn.executemany("INSERT INTO users VALUES (?, ?, ?)", [(1, "ada", 0.5), (2, "bob", 1.5), (3, "cy", None)])
    conn.commit()
    conn.close()
    return str(path)


def test_sqlite_read_static(pw, tmp_path):
    def scenario(pw):
        db = _users_db(tmp_path / f"{pw.__name__}.db")

        class S(pw.Schema):
            id: int
            name: str
            score: float | None

        t = pw.io.sqlite.read(db, "users", schema=S, mode="static")
        return sorted((r["id"], r["name"], r["score"]) for r in _collect(pw, t))

    assert _same(pw, scenario) == [(1, "ada", 0.5), (2, "bob", 1.5), (3, "cy", None)]


def test_sqlite_streaming_picks_up_changes(pw, tmp_path):
    """A streaming read sees an insert and a delete made between two polls."""

    def scenario(pw):
        db = _users_db(tmp_path / f"{pw.__name__}.db")

        class S(pw.Schema):  # keyed: a row gone from the table deletes its key
            id: int = pw.column_definition(primary_key=True)
            name: str

        t = pw.io.sqlite.read(db, "users", schema=S, poll_interval_s=0.02)
        runner = _mod(pw, "internals.graph_runner").GraphRunner()
        cap, names = runner.capture(t)
        th = threading.Thread(target=runner.run, daemon=True)
        th.start()

        def rows():
            return sorted((row[names.index("id")], row[names.index("name")]) for row in list(cap.state.values()))

        deadline = time.monotonic() + 30
        while len(rows()) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        first = rows()
        conn = sqlite3.connect(db)
        conn.execute("DELETE FROM users WHERE id = 2")
        conn.execute("INSERT INTO users VALUES (4, 'dee', 2.5)")
        conn.commit()
        conn.close()
        while rows() != [(1, "ada"), (3, "cy"), (4, "dee")] and time.monotonic() < deadline:
            time.sleep(0.01)
        runner.engine.stop()
        conn = sqlite3.connect(db)
        conn.execute("DROP TABLE users")  # a reader that polls for ever fails on its next poll and ends
        conn.close()
        th.join(timeout=30)
        pw.clear_graph()
        assert not th.is_alive()
        return first, rows()

    assert _same(pw, scenario) == ([(1, "ada"), (2, "bob"), (3, "cy")], [(1, "ada"), (3, "cy"), (4, "dee")])


def test_sqlite_missing_table_fails(pw, tmp_path):
    db = tmp_path / "d.db"
    sqlite3.connect(db).close()
    t = pw.io.sqlite.read(str(db), "ghost", schema=pw.schema_from_types(id=int), mode="static")
    with pytest.raises(Exception):
        _collect(pw, t)
    pw.clear_graph()


# ---------------------------------------------------------- the formats


def test_dsv_parser_and_formatter(pw):
    f = _mod(pw, "io._formats")
    p = f.DsvParser(separator=";")
    assert p.parse("a;b") == []  # header
    assert p.parse("1;2") == [("insert", {"a": "1", "b": "2"})]
    with pytest.raises(ValueError, match="row has 3 fields"):
        p.parse("1;2;3")
    quoted = f.DsvParser(field_names=["a", "b"], settings=f.CsvParserSettings(comment_character="#"))
    assert quoted.parse('"x,y",2\r\n') == [("insert", {"a": "x,y", "b": "2"})] and quoted.parse("# note") == []
    fmt = f.DsvFormatter(["a", "b"], separator="|")
    assert fmt.header() == "a|b|time|diff" and fmt.format({"a": 1, "b": "x"}, 4, -1) == "1|x|4|-1"


def test_jsonlines_parser_and_formatter(pw):
    f = _mod(pw, "io._formats")
    p = f.JsonLinesParser(field_names=["a"])
    assert p.parse('{"a": 1, "b": 2}') == [("insert", {"a": 1})] and p.parse(b'{"b": 2}') == [("insert", {"a": None})]
    with pytest.raises(ValueError):
        p.parse("[1, 2]")
    out = f.JsonLinesFormatter(["a", "b"]).format({"a": (1, 2), "b": b"\x01"}, 7, 1)
    assert json.loads(out) == {"a": [1, 2], "b": [1], "time": 7, "diff": 1}


def test_psql_formatters(pw):
    f = _mod(pw, "io._formats")
    sql, params = f.PsqlUpdatesFormatter("t", ["a", "b"]).format({"a": 1, "b": 2}, 10, 1)
    assert sql == "INSERT INTO t (a,b,time,diff) VALUES (%s,%s,10,1)" and params == (1, 2)
    s = f.PsqlSnapshotFormatter("t", ["a"], ["a", "b"])
    sql, params = s.format({"a": 1, "b": 2}, 10, 1)
    assert sql == ("INSERT INTO t (a,b,time,diff) VALUES (%s,%s,10,1) ON CONFLICT (a) DO UPDATE SET "
                   "b=EXCLUDED.b,time=10,diff=1 WHERE t.time<=10") and params == (1, 2)
    sql, params = s.format({"a": 1, "b": 2}, 11, -1)
    assert sql == "DELETE FROM t WHERE a=%s AND time<=11" and params == (1,)
    key_only = f.PsqlSnapshotFormatter("t", ["a"], ["a"]).format({"a": 1}, 3, 1)[0]
    assert "DO UPDATE SET time=3,diff=1 WHERE" in key_only
    with pytest.raises(ValueError, match="unknown key fields"):
        f.PsqlSnapshotFormatter("t", ["missing"], ["a"])


def test_bson_single_column_null_and_identity(pw):
    f = _mod(pw, "io._formats")
    assert f.BsonFormatter(["a"]).format({"a": (1, 2)}, 3, 1) == {"a": [1, 2], "time": 3, "diff": 1}
    assert f.SingleColumnFormatter("a").format({"a": "v", "b": 1}, 0, 1) == "v"
    assert f.NullFormatter().format({"a": 1}, 0, 1) is None and f.NullFormatter().field_names == []
    assert f.IdentityParser().parse("x") == [("insert", {"data": b"x"})]
    assert f.IdentityParser(column="c", as_bytes=False).parse(b"y") == [("insert", {"c": "y"})]


def test_jsonable_value(pw):
    import datetime

    import numpy as np

    value = _mod(pw, "engine.value")
    f = _mod(pw, "io._formats")
    got = f.jsonable_value({
        "j": value.Json({"a": 1}), "b": b"\x02", "arr": np.arange(2), "i": np.int64(3), "f": np.float32(0.5),
        "t": (1, [2]), "dt": datetime.datetime(2026, 1, 2, 3, 4, 5), "td": datetime.timedelta(seconds=2),
    })
    assert got == {"j": {"a": 1}, "b": [2], "arr": [0, 1], "i": 3, "f": 0.5, "t": [1, [2]],
                   "dt": "2026-01-02 03:04:05", "td": 2_000_000_000}
    assert f.jsonable_value(value.Pointer(5)) == repr(value.Pointer(5))
