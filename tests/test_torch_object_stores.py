"""The port's object stores held against the JAX package's, on the CPU.

The slice's cases of ``tests/test_connector_clients.py``,
``tests/test_connector_matrix_r4.py``, ``tests/test_connectors_extra.py`` and
``tests/test_parsers_depth.py``, each run on both packages through the same
injected fakes: S3 (static, streaming, a fetch that fails, a listing that
dies), s3_csv and MinIO, PyFilesystem, Google Drive, Delta Lake read and
write, Airbyte (a sync, its STATE resumed across a restart, the stream
filter, the serverless runtime's docker and venv resolution with no docker
and no pip run), the object cache (no download twice across restarts), the
size limit on a fresh fetch, on a cache hit and after the limit changes, and
``OpenParse`` through the reference's ``openparse`` shim. Then what the
reference's own tests leave out: ``list_objects_v2`` pagination, upserts on
a new ETag and retractions on a deletion in a streaming scan, the
``AwsS3Settings.create_client()`` branch and ``Backend.s3(bucket_settings=)``
against ``chip_smoke.py``'s ``boto3`` stand-in in ``sys.modules``. A case
on the port also runs the scenario on the reference and requires equal
results. A streaming reader of the reference scans until
``PATHWAY_TPU_FS_ONESHOT`` is set: each streaming case sets it, at once or
from its fake once the fake has served its last state.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import sys
import threading
import types

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import S3StandIn  # noqa: E402

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


def _plain(value):
    """A row's value with the package's ``Json`` unwrapped, comparable across packages."""
    if hasattr(value, "value") and type(value).__name__ == "Json":
        return json.dumps(value.value, sort_keys=True)
    return value


def _collect(pw, table, first=None, first_rows: int = 0, **run_kw) -> list:
    """The table's update stream under ``pw.run`` -> sorted (row values...,
    is_addition). The event ``first``, when given, is set once ``first_rows``
    rows have arrived: a fake that waits on it before its next state keeps
    that state out of the first epoch, whatever the load."""
    rows = []

    def on_change(key, row, time, is_addition):
        rows.append((*(_plain(row[c]) for c in sorted(row)), is_addition))
        if first is not None and len(rows) >= first_rows:
            first.set()

    pw.io.subscribe(table, on_change=on_change)
    pw.run(monitoring_level="none", **run_kw)
    pw.clear_graph()
    return sorted(rows)


def _schema(pw, **cols):
    return pw.schema_from_types(**cols)


class FakeS3:
    """The reference's boto3-shaped client over an in-memory dict, with a
    content ETag (the reference's test hashes the payload per process)."""

    def __init__(self, objects: dict):
        self.objects = objects

    def list_objects_v2(self, Bucket, Prefix, **kw):  # noqa: N803
        contents = [{"Key": k, "ETag": f"e{len(v)}-{sum(v)}"} for k, v in sorted(self.objects.items())
                    if k.startswith(Prefix)]
        return {"Contents": contents, "IsTruncated": False}

    def get_object(self, Bucket, Key):  # noqa: N803
        import io

        return {"Body": io.BytesIO(self.objects[Key])}


class FakeFS:
    """The reference's minimal PyFilesystem-shaped object."""

    def __init__(self, files: dict):
        self.files = files
        outer = self
        self.walk = types.SimpleNamespace(files=lambda path: [p for p in sorted(outer.files) if p.startswith(path)])

    def getinfo(self, p, namespaces=None):
        return types.SimpleNamespace(size=len(self.files[p]), modified=None)

    def readbytes(self, p):
        return self.files[p]


class FakeDrive:
    def __init__(self, files: dict, sizes: dict | None = None):
        self.files = files
        self.sizes = dict(sizes or {})
        self.gets = 0

    def list_objects(self):
        return [(k, f"v{len(v)}") for k, v in sorted(self.files.items())]

    def get_object(self, key):
        self.gets += 1
        return self.files[key]


# ------------------------------------------------------------------ s3


def test_s3_read_static_jsonlines(pw):
    def scenario(pw):
        objs = {"data/a.jsonl": b'{"word": "cat"}\n{"word": "dog"}\n', "data/b.jsonl": b'{"word": "emu"}\n',
                "other/skip.jsonl": b'{"word": "no"}\n'}
        t = pw.io.s3.read("s3://bucket/data/", format="json", schema=_schema(pw, word=str), mode="static",
                          _client=FakeS3(objs))
        return _collect(pw, t)

    assert _same(pw, scenario) == [("cat", True), ("dog", True), ("emu", True)]


@pytest.mark.parametrize("fmt", ["plaintext", "plaintext_by_file", "binary"])
def test_s3_read_streaming_formats_with_metadata(pw, monkeypatch, fmt):
    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")

    def scenario(pw):
        objs = {"d/a.txt": b"hello\nworld\n", "d/b.txt": b"third\n"}
        t = pw.io.s3.read("s3://b/d/", format=fmt, mode="streaming", with_metadata=True, _client=FakeS3(objs))
        return _collect(pw, t)

    got = _same(pw, scenario)
    assert len(got) == {"plaintext": 3, "plaintext_by_file": 2, "binary": 2}[fmt]
    assert all(json.loads(r[0])["path"].startswith("d/") for r in got)  # columns by name: _metadata, data


def test_s3_streaming_upserts_on_a_new_etag_and_retracts_a_deletion(pw, monkeypatch):
    """Three listings: the first state, then (once its rows have arrived)
    one object rewritten (a new ETag), one deleted and one added, then
    nothing new; the fake sets ``PATHWAY_TPU_FS_ONESHOT`` at its last
    listing, so both readers end."""

    def scenario(pw):
        states = [
            {"p/a.txt": b"alpha\n", "p/b.txt": b"beta\nbeta two\n", "p/c.txt": b"gamma\n"},
            {"p/a.txt": b"alpha v2\n", "p/c.txt": b"gamma\n", "p/d.txt": b"delta\n"},
            {"p/a.txt": b"alpha v2\n", "p/c.txt": b"gamma\n", "p/d.txt": b"delta\n"},
        ]

        first = threading.Event()

        class Scripted(FakeS3):
            def __init__(self):
                super().__init__(states[0])
                self.listings = 0

            def list_objects_v2(self, Bucket, Prefix, **kw):  # noqa: N803
                if self.listings == 1:
                    assert first.wait(30)
                self.objects = states[min(self.listings, len(states) - 1)]
                self.listings += 1
                if self.listings >= len(states):
                    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")
                return super().list_objects_v2(Bucket, Prefix)

        monkeypatch.delenv("PATHWAY_TPU_FS_ONESHOT", raising=False)
        t = pw.io.s3.read("s3://b/p/", format="plaintext", mode="streaming", poll_interval_s=0.01,
                          _client=Scripted())
        return _collect(pw, t, first, 4)

    assert _same(pw, scenario) == [
        ("alpha", False), ("alpha", True), ("alpha v2", True), ("beta", False), ("beta", True),
        ("beta two", False), ("beta two", True), ("delta", True), ("gamma", True),
    ]


def test_s3_pagination_and_the_aws_settings_branch(pw, monkeypatch):
    """``AwsS3Settings.create_client()`` through a ``boto3`` stand-in, a
    listing of 2,500 keys in pages of 1,000 (``IsTruncated``,
    ``NextContinuationToken``), every object fetched once."""

    def scenario(pw):
        stand_in = S3StandIn(page_size=1000)
        for name, mod in stand_in.modules().items():
            monkeypatch.setitem(sys.modules, name, mod)
        stand_in.apply("docs", {f"corpus/{i:05d}.txt": f"doc {i}\n".encode() for i in range(2500)})
        stand_in.apply("docs", {"elsewhere/x.txt": b"not under the prefix\n"})
        settings = pw.io.s3.AwsS3Settings(bucket_name="docs", endpoint="http://127.0.0.1:9000", with_path_style=True,
                                          region="eu-west-1", access_key="ak", secret_access_key="sk")
        t = pw.io.s3.read("corpus/", aws_s3_settings=settings, format="plaintext", mode="static")
        rows = _collect(pw, t)
        (client,) = stand_in.clients
        return (len(rows), rows[:2], stand_in.calls["list_objects_v2"], stand_in.calls["get_object"],
                max(stand_in.gets.values()), client["endpoint_url"], client["region_name"],
                client["aws_access_key_id"], client["config"].kwargs)

    assert _same(pw, scenario) == (2500, [("doc 0", True), ("doc 1", True)], 3, 2500, 1, "http://127.0.0.1:9000",
                                   "eu-west-1", "ak", {"s3": {"addressing_style": "path"}})


def test_s3_settings_without_boto3_raise_and_the_bucket_is_required(pw, monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(ImportError, match="pw.io.s3 requires the 'boto3' package"):
        pw.io.s3.AwsS3Settings(bucket_name="b").create_client()
    with pytest.raises(ValueError, match="bucket_name or an s3:// path"):
        pw.io.s3.read("prefix/", mode="static", _client=FakeS3({}))
    assert _mod(pw, "io.s3")._split_path("s3://bkt/a/b", None) == ("bkt", "a/b")


def test_s3_digital_ocean_wasabi_s3_csv_and_minio(pw):
    def scenario(pw):
        objs = {"p/x.csv": b"k,v\nx,1\ny,2\n", "p/y.txt": b"one\ntwo\n"}
        kv = _schema(pw, k=str, v=int)
        got = [_collect(pw, pw.io.s3_csv.read("s3://b/p/x", schema=kv, mode="static", _client=FakeS3(objs)))]
        settings = pw.io.minio.MinIOSettings("play.min.io", "bucket", "ak", "sk")
        aws = settings.create_aws_settings()
        got.append((aws.endpoint, aws.bucket_name, aws.with_path_style, aws.access_key))
        got.append(_collect(pw, pw.io.minio.read("p/x", settings, format="csv", schema=kv, mode="static",
                                                 _client=FakeS3(objs))))
        do = pw.io.s3.AwsS3Settings(bucket_name="b", endpoint="https://ams3.digitaloceanspaces.com")
        got.append(_collect(pw, pw.io.s3.read_from_digital_ocean("p/y", do, mode="static", _client=FakeS3(objs))))
        got.append(_collect(pw, pw.io.s3.read_from_wasabi("p/y", do, mode="static", _client=FakeS3(objs))))
        return got

    assert _same(pw, scenario) == [
        [("x", 1, True), ("y", 2, True)], ("https://play.min.io", "bucket", True, "ak"),
        [("x", 1, True), ("y", 2, True)], [("one", True), ("two", True)], [("one", True), ("two", True)],
    ]


class FlakyS3(FakeS3):
    def get_object(self, Bucket, Key):  # noqa: N803
        raise ConnectionError(f"transient fetch failure: {Key}")


class HalfDeadS3(FakeS3):
    def __init__(self):
        super().__init__({"a.txt": b"alpha\n"})
        self.calls = 0

    def list_objects_v2(self, Bucket, Prefix, **kw):  # noqa: N803
        self.calls += 1
        if self.calls > 1:
            raise ConnectionError("listing failed")
        return super().list_objects_v2(Bucket, Prefix)


def test_s3_static_fetch_failure_and_a_dying_listing_fail_loudly(pw):
    with pytest.raises(ConnectionError):
        pw.io.s3.read("s3://b/", format="plaintext", mode="static", _client=FlakyS3({"k": b"v\n"}))
    pw.clear_graph()
    t = pw.io.s3.read("s3://b/", format="plaintext", mode="streaming", poll_interval_s=0.01, _client=HalfDeadS3())
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: None)
    with pytest.raises(_mod(pw, "engine.dataflow").EngineError, match="failed"):
        pw.run(monitoring_level="none")


# ------------------------------------------------------ pyfilesystem, gdrive


def test_pyfilesystem_and_gdrive_read(pw):
    def scenario(pw):
        got = [_collect(pw, pw.io.pyfilesystem.read(FakeFS({"/docs/a.txt": b"alpha\nbeta\n", "/x/b.txt": b"no\n"}),
                                                     "/docs", format="plaintext", mode="static"))]
        got.append(_collect(pw, pw.io.pyfilesystem.read(FakeFS({"/d/a.bin": b"\x00\x01"}), "/d", mode="static",
                                                        with_metadata=True)))
        got.append(_collect(pw, pw.io.gdrive.read("folder-id", mode="static", format="plaintext",
                                                  _client=FakeDrive({"f1": b"doc one\n", "f2": b"doc two\n"}))))
        return got

    assert _same(pw, scenario) == [
        [("alpha", True), ("beta", True)], [(json.dumps({"path": "/d/a.bin"}), b"\x00\x01", True)],
        [("doc one", True), ("doc two", True)],
    ]


def test_gdrive_client_needs_its_package(pw, monkeypatch):
    monkeypatch.setitem(sys.modules, "googleapiclient", None)
    monkeypatch.setitem(sys.modules, "googleapiclient.discovery", None)
    with pytest.raises(ImportError, match="google-api-python-client"):
        _mod(pw, "io.gdrive")._GDriveClient("folder", "creds.json")


def test_gdrive_client_lists_pages_and_passes_sizes(pw, monkeypatch):
    """``_GDriveClient`` over stand-ins of the Google modules: two pages of
    the listing, sizes swapped per listing, a native Doc served empty."""

    class Request:
        def __init__(self, fn):
            self.execute = fn

    class Files:
        def __init__(self):
            self.pages = {None: ([{"id": "a", "md5Checksum": "m1", "size": "5"},
                                  {"id": "doc", "modifiedTime": "t1"}], "p2"),
                          "p2": ([{"id": "b", "md5Checksum": "m2", "size": "500"}], None)}

        def list(self, q, fields, pageToken=None):  # noqa: N803
            files, nxt = self.pages[pageToken]
            return Request(lambda: {"files": files, **({"nextPageToken": nxt} if nxt else {})})

        def get_media(self, fileId):  # noqa: N803
            if fileId == "doc":
                def fail():
                    raise RuntimeError("fileNotDownloadable: only files with binary content can be downloaded")
                return Request(fail)
            return Request(lambda: {"a": b"small", "b": b"x" * 500}[fileId])

    files = Files()
    oauth2 = types.ModuleType("google.oauth2")
    service_account = types.ModuleType("google.oauth2.service_account")
    service_account.Credentials = types.SimpleNamespace(from_service_account_file=lambda path, scopes: ("creds", path))
    discovery = types.ModuleType("googleapiclient.discovery")
    discovery.build = lambda name, version, credentials: types.SimpleNamespace(files=lambda: files)
    for name, mod in {"google.oauth2": oauth2, "google.oauth2.service_account": service_account,
                      "googleapiclient": types.ModuleType("googleapiclient"),
                      "googleapiclient.discovery": discovery}.items():
        monkeypatch.setitem(sys.modules, name, mod)
    client = _mod(pw, "io.gdrive")._GDriveClient("folder", "creds.json")
    assert client.list_objects() == [("a", "m1"), ("doc", "t1"), ("b", "m2")]
    assert client.sizes == {"a": 5, "b": 500}
    assert (client.get_object("a"), client.get_object("doc")) == (b"small", b"")

    def scenario(pw):
        t = pw.io.gdrive.read("folder", mode="static", format="binary", object_size_limit=100,
                              service_user_credentials_file="creds.json")
        return _collect(pw, t)

    assert _same(pw, scenario) == [(b"", True), (b"", True), (b"small", True)]


# ------------------------------------------------------------ size limits


def test_gdrive_object_size_limit_and_metadata_skip(pw):
    def scenario(pw):
        big = FakeDrive({"small": b"x" * 4, "big": b"x" * 1000}, sizes={"big": 1000})
        rows = _collect(pw, pw.io.gdrive.read("folder", mode="static", format="binary", object_size_limit=100,
                                              _client=big))
        return [len(r[0]) for r in rows], big.gets

    # the listing's size skips the download of ``big``
    assert _same(pw, scenario) == ([0, 4], 1)


def test_size_limit_cache_and_offset_interactions(pw, tmp_path, monkeypatch):
    """A cached full payload must not bypass a later limit; an object
    skipped by the limit re-downloads when the limit is raised."""
    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")

    def scenario(pw):
        root = tmp_path / pw.__name__
        cache_dir, backend = str(root / "cache"), pw.persistence.Backend.filesystem(str(root / "p"))

        def run_once(limit):
            drive = FakeDrive({"doc": b"x" * 200})
            t = pw.io.gdrive.read("folder", mode="streaming", format="binary", object_size_limit=limit,
                                  object_cache=cache_dir, persistent_id="gd", _client=drive)
            rows = _collect(pw, t, persistence_config=pw.persistence.Config.simple_config(backend))
            return [(len(r[0]), r[1]) for r in rows], drive.gets

        return [run_once(None), run_once(100), run_once(100), run_once(1000)]

    assert _same(pw, scenario) == [
        ([(200, True)], 1),  # no limit: served and cached
        ([(0, True), (200, False)], 0),  # a limit: the cached payload is not served, and not downloaded
        ([], 0),  # the same limit: nothing again
        ([(0, False), (200, True)], 0),  # raised past the size: the full content again, from the cache
    ]


# ------------------------------------------------------------ object cache


def test_object_cache_zero_redownloads_across_restarts(pw, tmp_path):
    def scenario(pw):
        cache_dir = str(tmp_path / pw.__name__ / "objcache")
        objs = {"a.txt": b"alpha\n", "b.txt": b"beta\n"}

        def run_once(objects):
            drive = FakeDrive(objects)
            rows = _collect(pw, pw.io.gdrive.read("folder", mode="static", format="plaintext", _client=drive,
                                                  object_cache=cache_dir))
            return [r[0] for r in rows], drive.gets

        got = [run_once(objs), run_once(objs), run_once({**objs, "b.txt": b"beta2!\n"})]
        _mod(pw, "io._object_store").ObjectCache(cache_dir).drop("a.txt")
        got.append(run_once(objs))
        return got

    assert _same(pw, scenario) == [
        (["alpha", "beta"], 2), (["alpha", "beta"], 0), (["alpha", "beta2!"], 1), (["alpha", "beta"], 2),
    ]


def test_object_cache_files_are_the_references(tmp_path):
    """The port writes the reference's layout (a ``.bin`` and a ``.meta`` per
    key): a cache written by one package serves the other."""
    from pathway_tpu.io._object_store import ObjectCache as JCache
    from pathway_tpu_torch.io._object_store import ObjectCache as TCache

    root = str(tmp_path / "cache")
    TCache(root).put("a/b.txt", ["etag", 3], b"payload")
    assert JCache(root).get("a/b.txt", ["etag", 3]) == b"payload"
    assert JCache(root).get("a/b.txt", ["etag", 4]) is None and TCache(root)._paths("k") == JCache(root)._paths("k")
    JCache(root).put("c.txt", "v1", b"other")
    assert TCache(root).get("c.txt", "v1") == b"other"
    TCache(root).drop("c.txt")
    assert JCache(root).get("c.txt", "v1") is None
    assert sorted(os.listdir(root)) == sorted(os.path.basename(p) for p in TCache(root)._paths("a/b.txt"))


@pytest.mark.parametrize("fmt,payload", [
    ("binary", b"\x00raw"),
    ("plaintext", b"one\n\ntwo\n"),
    ("plaintext_by_file", b"whole\nfile\n"),
    ("csv", b"a;b\n1;2\n"),
    ("json", b'{"a": 1}\n\n{"a": 2}\n'),
])
def test_rows_from_payload_and_default_schema(pw, fmt, payload):
    store = _mod(pw, "io._object_store")
    kw = lambda pkg: {"csv_settings": pkg.io.CsvParserSettings(delimiter=";")} if fmt == "csv" else {}  # noqa: E731
    got = store.rows_from_payload(payload, fmt, True, {"path": "k"}, **kw(pw))
    want = _mod(jpw, "io._object_store").rows_from_payload(payload, fmt, True, {"path": "k"}, **kw(jpw))
    assert [{k: _plain(v) for k, v in r.items()} for r in got] == [{k: _plain(v) for k, v in r.items()} for r in want]
    assert store.default_schema(fmt, True).column_names() == ["data", "_metadata"]
    with pytest.raises(ValueError, match="unsupported format"):
        store.rows_from_payload(b"", "parquet", False, None)


# ------------------------------------------------------------ deltalake


def test_deltalake_read_versions_upserts_and_retractions(pw, monkeypatch):
    """Versions 3, 3, 4: version 4 deletes one row, keeps one and adds two
    (one a duplicate); the fake serves version 4 once version 3's rows have
    arrived, and sets ``PATHWAY_TPU_FS_ONESHOT`` at its last version, so
    both readers end."""

    def scenario(pw):
        versions = [(3, [{"k": "x", "v": 1}, {"k": "y", "v": 2}]), (3, None),
                    (4, [{"k": "y", "v": 2}, {"k": "z", "v": 3}, {"k": "z", "v": 3}])]

        first = threading.Event()

        class FakeDelta:
            def __init__(self):
                self.polls, self.rows = 0, []

            def version(self):
                if self.polls == 2:
                    assert first.wait(30)
                v, rows = versions[min(self.polls, len(versions) - 1)]
                self.rows = rows if rows is not None else self.rows
                self.polls += 1
                if self.polls >= len(versions):
                    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")
                return v

            def to_pylist(self):
                return list(self.rows)

        monkeypatch.delenv("PATHWAY_TPU_FS_ONESHOT", raising=False)
        t = pw.io.deltalake.read("s3://lake/tbl", schema=_schema(pw, k=str, v=int), poll_interval_s=0.01,
                                 _table=FakeDelta())
        return _collect(pw, t, first, 2)

    assert _same(pw, scenario) == [("x", 1, False), ("x", 1, True), ("y", 2, True), ("z", 3, True), ("z", 3, True)]


def test_deltalake_static_read_and_write_batches(pw):
    def scenario(pw):
        class FakeDelta:
            def version(self):
                return 1

            def to_pylist(self):
                return [{"k": "x", "v": 1, "extra": 0}]

        got = [_collect(pw, pw.io.deltalake.read("/lake", schema=_schema(pw, k=str, v=int), mode="static",
                                                 _table=FakeDelta()))]
        written = []
        t = pw.debug.table_from_rows(schema=_schema(pw, k=str, v=int), rows=[("x", 1), ("y", 2)])
        pw.io.deltalake.write(t, "/lake/tbl", _writer=written.append)
        pw.run(monitoring_level="none")
        got.append(sorted((r["k"], r["v"], r["diff"]) for batch in written for r in batch))
        got.append(len(written))
        return got

    assert _same(pw, scenario) == [[("x", 1, True)], [("x", 1, 1), ("y", 2, 1)], 1]


def test_deltalake_without_its_package_raises(pw, monkeypatch):
    monkeypatch.setitem(sys.modules, "deltalake", None)
    with pytest.raises(ImportError, match="requires the 'deltalake' package"):
        _mod(pw, "io.deltalake")._DeltaTableHandle("/lake", None)


# --------------------------------------------------------------- airbyte


def _airbyte_source(records_by_sync):
    """The reference's fake Airbyte connector: each sync yields RECORD messages and a STATE."""
    calls = {"n": 0, "states": []}

    def source(config, state):
        sync_no = int(state["sync"]) + 1 if state else 0
        calls["n"] += 1
        calls["states"].append(state)
        msgs = [{"type": "RECORD", "record": {"stream": "users", "data": rec}} for rec in records_by_sync.get(sync_no, [])]
        msgs.append({"type": "STATE", "state": {"sync": sync_no}})
        return msgs

    return source, calls


def test_airbyte_static_sync_and_stream_filter(pw):
    def scenario(pw):
        source, calls = _airbyte_source({0: [{"id": 1}, {"id": 2}]})
        got = [_collect(pw, pw.io.airbyte.read(config={"k": "v"}, streams=["users"], source=source, mode="static"))]

        def two_streams(config, state):
            return [{"type": "RECORD", "record": {"stream": "users", "data": {"id": 1}}},
                    {"type": "RECORD", "record": {"stream": "orders", "data": {"id": 9}}}]

        got.append(_collect(pw, pw.io.airbyte.read(config={}, streams=["users"], source=two_streams, mode="static")))
        return got, calls["n"]

    assert _same(pw, scenario) == (
        [[(json.dumps({"id": 1}), "users", True), (json.dumps({"id": 2}), "users", True)],
         [(json.dumps({"id": 1}), "users", True)]], 1)


def test_airbyte_state_resumes_across_a_restart(pw, tmp_path, monkeypatch):
    monkeypatch.setenv("PATHWAY_TPU_FS_ONESHOT", "1")

    def scenario(pw):
        backend = pw.persistence.Backend.filesystem(str(tmp_path / pw.__name__ / "p"))
        data = {0: [{"id": 1}], 1: [{"id": 2}]}

        def run_once():
            source, calls = _airbyte_source(data)
            t = pw.io.airbyte.read(config={}, source=source, mode="streaming", persistent_id="ab")
            rows = _collect(pw, t, persistence_config=pw.persistence.Config.simple_config(backend))
            return rows, calls["states"]

        return [run_once(), run_once(), run_once()]

    assert _same(pw, scenario) == [
        ([(json.dumps({"id": 1}), "users", True)], [None]),
        ([(json.dumps({"id": 2}), "users", True)], [{"sync": 0}]),  # sync 1 on top of the recovered rows
        ([], [{"sync": 1}]),
    ]


def test_airbyte_requires_a_runtime_or_source(pw):
    with pytest.raises(ValueError, match="docker_image"):
        pw.io.airbyte.read(config={})
    with pytest.raises(ValueError, match="config= or config_file_path="):
        pw.io.airbyte.read()


def test_airbyte_docker_argv_and_source_resolution(pw, monkeypatch):
    """``_docker_argv``'s shape; ``_resolve_source_spec`` picks docker when
    asked, and the venv (here a stand-in for ``_venv_executable``, so no pip
    runs) when PyPI is enforced; nothing is executed."""
    airbyte = _mod(pw, "io.airbyte")
    argv = airbyte._docker_argv("airbyte/source-github", "/tmp/x", {"TOKEN": "t"})
    assert argv == ["docker", "run", "--rm", "-i", "--volume", "/tmp/x:/tmp/x", "-e", "TOKEN=t",
                    "airbyte/source-github"]
    config = {"source": {"docker_image": "airbyte/source-faker:6.2.10", "config": {"count": 2}}}
    factory, connector_config = airbyte._resolve_source_spec(config, "docker", {"A": "1"})
    assert connector_config == {"count": 2}
    assert factory("/sync") == ["docker", "run", "--rm", "-i", "--volume", "/sync:/sync", "-e", "A=1",
                                "airbyte/source-faker:6.2.10"]
    venvs = []
    monkeypatch.setattr(airbyte, "_venv_executable", lambda name, tag="": venvs.append((name, tag)) or ["/v/bin/x"])
    factory, _ = airbyte._resolve_source_spec(config, "pypi", None)
    assert factory("/sync") == ["/v/bin/x"] and venvs == [("source-faker", "6.2.10")]
    assert airbyte._resolve_source_spec({"source": {}}, None, None) == (None, None)


_CONNECTOR = r"""
import json, sys
args = sys.argv[1:]
state = json.load(open(args[args.index("--state") + 1])) if "--state" in args else None
config = json.load(open(args[args.index("--config") + 1]))
print("a log line that is not the protocol")
for i in range(config["count"]):
    print(json.dumps({"type": "RECORD", "record": {"stream": "users", "data": {"id": i, "state": state}}}))
print(json.dumps({"type": "STATE", "state": {"cursor": config["count"]}}))
"""


def test_airbyte_runs_a_connector_executable(pw, tmp_path):
    """The protocol over a subprocess: ``executable=`` argv, ``--config``
    and ``--state`` files, non-protocol lines skipped, a failing exit raised;
    and ``read`` through a config whose PyPI venv resolves to the script."""
    script = tmp_path / "connector.py"
    script.write_text(_CONNECTOR)
    airbyte = _mod(pw, "io.airbyte")
    msgs = list(airbyte._messages_from_executable([sys.executable, str(script)], {"count": 2}, {"cursor": 0}))
    assert [m["type"] for m in msgs] == ["RECORD", "RECORD", "STATE"]
    assert msgs[0]["record"]["data"] == {"id": 0, "state": {"cursor": 0}}
    with pytest.raises(RuntimeError, match="exited with code 3"):
        list(airbyte._messages_from_executable([sys.executable, "-c", "import sys; sys.exit(3)"], {}, None))

    def scenario(pw):
        t = pw.io.airbyte.read(config={"count": 3}, executable=[sys.executable, str(script)], mode="static")
        return _collect(pw, t)

    assert [json.loads(r[0])["id"] for r in _same(pw, scenario)] == [0, 1, 2]


def test_airbyte_reads_a_config_file(pw, tmp_path):
    script = tmp_path / "connector.py"
    script.write_text(_CONNECTOR)
    cfg = tmp_path / "connections.yaml"
    cfg.write_text("count: 2\n")

    def scenario(pw):
        t = pw.io.airbyte.read(str(cfg), executable=[sys.executable, str(script)], mode="static")
        return _collect(pw, t)

    assert len(_same(pw, scenario)) == 2


# ----------------------------------------------------- persistence on S3


def test_persistence_backend_s3_with_aws_settings(pw, monkeypatch):
    """``Backend.s3(root, bucket_settings=pw.io.s3.AwsS3Settings(...))``
    through ``create_client()`` on the ``boto3`` stand-in: an offset-aware
    subject resumes from its bookmark, its log and offsets live in the
    bucket under the root."""

    def scenario(pw):
        stand_in = S3StandIn(page_size=2)
        for name, mod in stand_in.modules().items():
            monkeypatch.setitem(sys.modules, name, mod)
        produced = ["a", "b", "c", "d"]

        class Cursor(pw.io.python.ConnectorSubject):
            supports_offsets = True

            def run(self):
                for i in range(int(self.offsets.get("pos", 0)), len(produced)):
                    self.next_with_offset("pos", i + 1, w=produced[i])
                self.commit()

        settings = pw.io.s3.AwsS3Settings(bucket_name="pstore", endpoint="http://127.0.0.1:9000", with_path_style=True)

        def run_once():
            backend = pw.persistence.Backend.s3("s3://pstore/pathway", bucket_settings=settings)
            t = pw.io.python.read(Cursor(), schema=_schema(pw, w=str), persistent_id="cur")
            return _collect(pw, t, persistence_config=pw.persistence.Config.simple_config(backend))

        got = [run_once(), run_once()]
        produced.append("e")
        got.append(run_once())
        keys = stand_in.keys("pstore")
        return got, bool(keys) and all(k.startswith("pathway/") for k in keys), len(stand_in.clients)

    got, under_root, clients = _same(pw, scenario)
    assert got == [[("a", True), ("b", True), ("c", True), ("d", True)], [], [("e", True)]]
    assert under_root and clients == 3


# -------------------------------------------------------------- openparse


def _install_fake_openparse(monkeypatch):
    """The reference's openparse shim (``tests/test_parsers_depth.py``)."""
    import tests.test_parsers_depth as depth

    return depth._install_fake_openparse(monkeypatch)


@pytest.fixture
def openparse_utils(pw):
    """The package's ``openparse_utils`` with its lazy classes purged before
    and after, so they resolve against this test's fake (or absent) package."""
    opu = _mod(pw, "xpacks.llm.openparse_utils")

    def clear():
        for name in opu._LAZY_NAMES:
            opu.__dict__.pop(name, None)

    clear()
    yield opu
    clear()


def test_openparse_utils_without_the_package(openparse_utils, monkeypatch):
    monkeypatch.setitem(sys.modules, "openparse", None)
    with pytest.raises(ImportError, match="openparse"):
        openparse_utils.SimpleIngestionPipeline
    args = openparse_utils.LLMArgs(llm=None)
    assert (args.parsing_algorithm, args.min_table_confidence, args.llm_model) == ("llm", 0.7, None)
    with pytest.raises(Exception):
        openparse_utils.LLMArgs(unexpected_field=1)
    with pytest.raises(Exception):
        openparse_utils.LLMArgs(min_table_confidence=1.5)
    with pytest.raises(AttributeError):
        openparse_utils.not_a_name


def test_openparse_pipelines_and_dispatch_with_the_shim(pw, openparse_utils, monkeypatch):
    op = _install_fake_openparse(monkeypatch)
    opu = openparse_utils
    assert len(opu.SimpleIngestionPipeline().transformations) == 11

    class E:
        def __init__(self, text, page):
            self.text, self.page = text, page

    n1, n2 = op.Node(elements=(E("a", 0), E("b", 1))), op.Node(elements=(E("c", 0),))
    assert sorted(n.text for n in opu.PageChunker().process([n1, n2])) == ["a c", "b"]
    assert sorted(n.text for n in opu.SamePageIngestionPipeline().run([n1, n2])) == ["a c", "b"]
    assert type(opu._table_args_dict_to_model({"parsing_algorithm": "pymupdf"})).__name__ == "PyMuPDFArgs"
    assert isinstance(opu._table_args_dict_to_model({"parsing_algorithm": "llm"}), opu.LLMArgs)
    with pytest.raises(ValueError, match="Unsupported"):
        opu._table_args_dict_to_model({"parsing_algorithm": "nope"})
    with pytest.raises(ValueError, match="Unsupported parsing_algorithm"):
        opu.ingest(op.Pdf(), object())
    parser = opu.PyMuDocumentParser(table_args={"parsing_algorithm": "pymupdf"},
                                    processing_pipeline=opu.SamePageIngestionPipeline())
    assert sorted(n.text for n in parser.parse(op.Pdf(file=None)).nodes) == ["hello pymupdf-table", "world"]


def test_openparse_parser_udf_with_the_shim(pw, openparse_utils, monkeypatch):
    _install_fake_openparse(monkeypatch)
    parsers = _mod(pw, "xpacks.llm.parsers")

    def scenario(pw):
        out = []
        for pipeline in ("merge_same_page", None):
            parser = _mod(pw, "xpacks.llm.parsers").OpenParse(table_args={"parsing_algorithm": "pymupdf"},
                                                              processing_pipeline=pipeline)
            out.append(sorted(asyncio.run(parser.__wrapped__(b"%PDF fake"))))
        return out

    assert _same(pw, scenario) == [[("hello pymupdf-table", {}), ("world", {})],
                                   [("hello", {}), ("pymupdf-table", {}), ("world", {})]]
    with pytest.raises(ValueError, match="processing_pipeline"):
        parsers.OpenParse(processing_pipeline="bogus")
    with pytest.raises(ValueError, match="Image parsing"):
        parsers.OpenParse(parse_images=True, image_args={"parsing_algorithm": "pymupdf"})
