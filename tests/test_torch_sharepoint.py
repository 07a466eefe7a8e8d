"""The port's SharePoint connector held against the JAX package's, on the CPU.

The cases of ``tests/test_sharepoint.py`` on both packages through the same
fake Office365 context (``_context_factory=``): the enterprise licence gate,
the scanner's snapshot diff with deletions, a partial failure that loses no
update, the size limit, the entry metadata, static reads with retries and
with too many failures, a restart that skips unchanged files and retracts
files deleted while down, and a streaming read that sees an update and a
deletion. Then the ``office365`` client's absence and its adapter over a
stand-in module. A case on the port also runs the scenario on the reference
and requires equal results.
"""

from __future__ import annotations

import importlib
import sys
import threading
import time
import types

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw

PACKAGES = {"reference": jpw, "port": tpw}


@pytest.fixture(params=sorted(PACKAGES))
def pw(request):
    for pkg in PACKAGES.values():
        pkg.clear_graph()
        pkg.set_license_key("enterprise-test")
    yield PACKAGES[request.param]
    for pkg in PACKAGES.values():
        pkg.clear_graph()
        pkg.set_license_key(None)


def _same(pw, scenario):
    """``scenario(pw)``; on the port also ``scenario(reference)``, which must be equal."""
    got = scenario(pw)
    pw.clear_graph()
    if pw is tpw:
        want = scenario(jpw)
        jpw.clear_graph()
        assert got == want
    return got


def _sp(pw):
    return importlib.import_module(f"{pw.__name__}.xpacks.connectors.sharepoint")


class FakeFile:
    def __init__(self, path, content, modified_at=100, created_at=50):
        self.path = path
        self._content = content
        self.size = len(content)
        self.created_at = created_at
        self.modified_at = modified_at
        self.reads = 0

    def read(self):
        self.reads += 1
        return self._content


class FakeContext:
    def __init__(self, files):
        self.files = list(files)
        self.scans = 0
        self.down = False

    def list_files(self, root_path, recursive):
        if self.down:
            raise ConnectionError("the site went away")
        self.scans += 1
        return list(self.files)


def _events(pw, table, **run_kw) -> list:
    events = []
    pw.io.subscribe(table, on_change=lambda key, row, time, is_addition: events.append((row["data"], is_addition)))
    pw.run(monitoring_level="none", **run_kw)
    pw.clear_graph()
    return events


def test_sharepoint_is_gated_by_the_licence(pw):
    pw.set_license_key(None)
    with pytest.raises(pw.LicenseError, match="xpack-sharepoint"):
        pw.xpacks.connectors.sharepoint.read("https://example.sharepoint.com/sites/S", root_path="Docs")
    pw.set_license_key("enterprise-test")
    with pytest.raises(ValueError, match="unknown mode"):
        pw.xpacks.connectors.sharepoint.read("https://x.sharepoint.com/sites/S", root_path="D", mode="batch",
                                             _context_factory=lambda: FakeContext([]))
    with pytest.raises(TypeError, match="missing required arguments: tenant, client_id, cert_path, thumbprint"):
        pw.xpacks.connectors.sharepoint.read("https://x.sharepoint.com/sites/S", root_path="D")


def test_scanner_snapshot_diff_and_deletions(pw):
    def scenario(pw):
        f1, f2 = FakeFile("/sites/S/Docs/a.txt", b"alpha"), FakeFile("/sites/S/Docs/b.txt", b"beta")
        ctx = FakeContext([f1, f2])
        scanner = _sp(pw)._Scanner(ctx, "Docs", True, {})
        out = []
        for files in ([f1, f2], [f1, f2], [f1]):
            if files == [f1]:
                f1.modified_at = 200
            ctx.files = files
            updated, deleted = scanner.get_snapshot_diff()
            out.append((sorted((payload, m.path) for payload, m in updated), deleted))
        return out, f1.reads, f2.reads

    assert _same(pw, scenario) == (
        [([(b"alpha", "/sites/S/Docs/a.txt"), (b"beta", "/sites/S/Docs/b.txt")], []), ([], []),
         ([(b"alpha", "/sites/S/Docs/a.txt")], ["/sites/S/Docs/b.txt"])], 2, 1)


def test_scanner_partial_failure_does_not_lose_updates(pw):
    def scenario(pw):
        class FlakyFile(FakeFile):
            fail_next = True

            def read(self):
                if self.fail_next:
                    self.fail_next = False
                    raise ConnectionError("transient")
                return super().read()

        stored: dict = {}
        scanner = _sp(pw)._Scanner(FakeContext([FakeFile("/s/a", b"A"), FlakyFile("/s/b", b"B")]), "s", True, stored)
        with pytest.raises(ConnectionError):
            scanner.get_snapshot_diff()
        leaked = dict(stored)
        updated, _deleted = scanner.get_snapshot_diff()
        return leaked, sorted(m.path for _, m in updated), sorted(stored)

    assert _same(pw, scenario) == ({}, ["/s/a", "/s/b"], ["/s/a", "/s/b"])


def test_scanner_size_limit_and_entry_meta(pw):
    def scenario(pw):
        sp = _sp(pw)
        small, big = FakeFile("/s/a", b"ok"), FakeFile("/s/b", b"x" * 1000)
        updated, _ = sp._Scanner(FakeContext([small, big]), "s", True, {}, object_size_limit=10).get_snapshot_diff()
        limited = sorted((payload, m.status) for payload, m in updated)
        f = FakeFile("/sites/S/Docs/a b.txt", b"x")
        meta = sp._EntryMeta(f, base_url="https://company.sharepoint.com")
        d = meta.as_dict()
        d.pop("seen_at")
        same = meta == sp._EntryMeta(f)
        f.modified_at = 999
        rebuilt = sp._EntryMeta.from_parts(f.path, 50, 999, 1)
        return (limited, big.reads, d, same, meta == sp._EntryMeta(f), rebuilt == sp._EntryMeta(f),
                rebuilt.as_offset())

    assert _same(pw, scenario) == (
        [(b"", "size_limit_exceeded"), (b"ok", "downloaded")], 0,
        {"created_at": 50, "modified_at": 100, "path": "/sites/S/Docs/a b.txt", "size": 1, "status": "downloaded",
         "url": "https://company.sharepoint.com/sites/S/Docs/a%20b.txt"},
        True, False, True, [50, 999, 1])


def test_sharepoint_static_read_with_metadata_and_retries(pw):
    def scenario(pw):
        files = [FakeFile("/sites/S/Docs/a.txt", b"alpha"), FakeFile("/sites/S/Docs/b.txt", b"beta")]
        t = pw.xpacks.connectors.sharepoint.read("https://company.sharepoint.com/sites/S",
                                                 root_path="Shared Documents/Docs", mode="static", with_metadata=True,
                                                 _context_factory=lambda: FakeContext(files))
        rows = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: rows.append(
            (row["data"], row["_metadata"].value["path"], row["_metadata"].value["url"], is_addition)))
        pw.run(monitoring_level="none")
        pw.clear_graph()
        calls = {"n": 0}

        def flaky_factory():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise ConnectionError("auth flake")
            return FakeContext([FakeFile("/s/a", b"data")])

        t = pw.xpacks.connectors.sharepoint.read("https://x.sharepoint.com/sites/S", root_path="Docs", mode="static",
                                                 refresh_interval=0, max_failed_attempts_in_row=5,
                                                 _context_factory=flaky_factory)
        return sorted(rows), _events(pw, t), calls["n"]

    assert _same(pw, scenario) == (
        [(b"alpha", "/sites/S/Docs/a.txt", "https://company.sharepoint.com/sites/S/Docs/a.txt", True),
         (b"beta", "/sites/S/Docs/b.txt", "https://company.sharepoint.com/sites/S/Docs/b.txt", True)],
        [(b"data", True)], 3)


def test_sharepoint_aborts_after_max_failures(pw):
    def factory():
        raise ConnectionError("bad credentials")

    t = pw.xpacks.connectors.sharepoint.read("https://x.sharepoint.com/sites/S", root_path="Docs", mode="static",
                                             refresh_interval=0, max_failed_attempts_in_row=3,
                                             _context_factory=factory)
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: None)
    dataflow = importlib.import_module(f"{pw.__name__}.engine.dataflow")
    with pytest.raises(dataflow.EngineError, match="sharepoint.*failed"):
        pw.run(monitoring_level="none")


def test_sharepoint_restart_skips_unchanged_and_retracts_downtime_deletions(pw, tmp_path):
    def scenario(pw):
        f1, f2, f3 = FakeFile("/s/a.txt", b"one"), FakeFile("/s/b.txt", b"two"), FakeFile("/s/c.txt", b"three")
        backend = pw.persistence.Backend.filesystem(str(tmp_path / pw.__name__ / "snap"))

        def run_once(files):
            t = pw.xpacks.connectors.sharepoint.read("https://x.sharepoint.com/sites/S", root_path="Docs",
                                                     mode="static", persistent_id="sp1",
                                                     _context_factory=lambda: FakeContext(files))
            return sorted(_events(pw, t, persistence_config=pw.persistence.Config.simple_config(backend)))

        first = run_once([f1, f2])
        # while down: a.txt rewritten, b.txt deleted, c.txt added; then a restart with nothing new
        f1b = FakeFile("/s/a.txt", b"one v2", modified_at=300)
        second = run_once([f1b, f3])
        third = run_once([f1b, f3])
        return first, second, third, (f1.reads, f2.reads, f1b.reads, f3.reads)

    assert _same(pw, scenario) == (
        [(b"one", True), (b"two", True)], [(b"one", False), (b"one v2", True), (b"three", True), (b"two", False)],
        [], (1, 1, 1, 1))


def test_sharepoint_streaming_sees_an_update_and_a_deletion(pw):
    """The port's reader ends with its run; the reference's scans for ever,
    so its context raises once the run is stopped and the reader gives up
    after ``max_failed_attempts_in_row``."""

    def scenario(pw):
        ctx = FakeContext([FakeFile("/s/a.txt", b"one"), FakeFile("/s/c.txt", b"kept")])
        t = pw.xpacks.connectors.sharepoint.read("https://x.sharepoint.com/sites/S", root_path="Docs",
                                                 mode="streaming", refresh_interval=0.02, autocommit_duration_ms=20,
                                                 max_failed_attempts_in_row=2, _context_factory=lambda: ctx)
        events = []
        pw.io.subscribe(t, on_change=lambda key, row, time, is_addition: events.append((row["data"], is_addition)))
        runner = importlib.import_module(f"{pw.__name__}.internals.graph_runner").GraphRunner()
        for spec in list(pw.parse_graph.subscriptions):
            runner.subscribe(spec["table"], on_change=spec.get("on_change"))

        def wait_for(cond):
            deadline = time.monotonic() + 30
            while not cond() and time.monotonic() < deadline:
                time.sleep(0.01)

        def mutate():
            wait_for(lambda: len(events) >= 2)
            ctx.files = [FakeFile("/s/a.txt", b"one v2", modified_at=200), FakeFile("/s/c.txt", b"kept")]
            wait_for(lambda: (b"one v2", True) in events)
            ctx.files = [FakeFile("/s/c.txt", b"kept")]
            wait_for(lambda: (b"one v2", False) in events)
            runner.engine.stop()
            ctx.down = True

        th = threading.Thread(target=mutate, daemon=True)
        th.start()
        runner.run()
        th.join(timeout=30)
        pw.clear_graph()
        return sorted(events)

    assert _same(pw, scenario) == [(b"kept", True), (b"one", False), (b"one", True), (b"one v2", False),
                                   (b"one v2", True)]


def test_office365_context_over_a_stand_in(pw, monkeypatch):
    """Without ``office365`` a real read raises the reference's ImportError;
    over a stand-in module the adapter lists and reads files."""
    monkeypatch.setitem(sys.modules, "office365", None)
    with pytest.raises(ImportError, match="Office365-REST-Python-Client"):
        pw.xpacks.connectors.sharepoint.read("https://x.sharepoint.com/sites/S", root_path="D", tenant="t",
                                             client_id="c", cert_path="p", thumbprint="h")

    class Query:
        def __init__(self, value):
            self.value = value

        def execute_query(self):
            return self

    class Files(list):
        def execute_query(self):
            return self

    class Entry:
        def __init__(self, url, body):
            import datetime

            self.properties = {"ServerRelativeUrl": url}
            self.length = len(body)
            self.time_created = datetime.datetime.fromtimestamp(50, datetime.timezone.utc)
            self.time_last_modified = datetime.datetime.fromtimestamp(90, datetime.timezone.utc)
            self._body = body

        def get_content(self):
            return Query(self._body)

    class ClientContext:
        def __init__(self, url):
            self.url = url
            self.web = types.SimpleNamespace(get_folder_by_server_relative_path=lambda path: types.SimpleNamespace(
                get_files=lambda recursive: Files([Entry(f"{path}/a.txt", b"alpha")])))

        def with_client_certificate(self, **kw):
            self.cert = kw
            return self

        def load(self, web):
            pass

        def execute_query(self):
            pass

    mod = types.ModuleType("office365.sharepoint.client_context")
    mod.ClientContext = ClientContext
    for name, m in {"office365": types.ModuleType("office365"),
                    "office365.sharepoint": types.ModuleType("office365.sharepoint"),
                    "office365.sharepoint.client_context": mod}.items():
        monkeypatch.setitem(sys.modules, name, m)
    ctx = _sp(pw)._Office365Context("https://x.sharepoint.com/sites/S", "t", "c", "h", "p")
    (f,) = ctx.list_files("/sites/S/Docs", True)
    assert (f.path, f.size, f.created_at, f.modified_at, f.read()) == ("/sites/S/Docs/a.txt", 5, 50, 90, b"alpha")
    assert ctx._context.cert == {"tenant": "t", "client_id": "c", "thumbprint": "h", "cert_path": "p"}
