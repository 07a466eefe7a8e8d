"""The port's crash window, held against the reference's sink output.

The single-process cases of ``tests/test_chaos_crash_window.py`` and of
``tests/test_pipeline.py``'s staging crashes: a wordcount whose every input
row is an epoch runs clean on both packages (the port's sink output must be
byte for byte the reference's), then on the port through a scripted crash
under the supervisor, on the filesystem, mock and faked-S3 backends, at
pipeline depth 1 and 2, on one engine worker and on four (the threaded
cluster). Every crash run's output equals the clean run's; the one
at-least-once window (after the sink flush, before the delivered marker)
re-delivers one epoch whose net state is the clean run's. A SIGKILL in a
child process, mid-epoch, resumes to byte-identical output.
"""

from __future__ import annotations

import io
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu_torch.resilience import Recovery, RetryPolicy, chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["cat", "dog", "bird", "cat", "dog", "cat", "emu", "dog"]
FINAL = {"cat": 3, "dog": 3, "bird": 1, "emu": 1}


class MemS3:
    """An in-memory boto3-shaped client (the reference's own fake)."""

    def __init__(self):
        self.objects: dict[str, bytes] = {}

    def put_object(self, Bucket, Key, Body):
        self.objects[Key] = Body if isinstance(Body, bytes) else Body.read()

    def get_object(self, Bucket, Key):
        return {"Body": io.BytesIO(self.objects[Key])}

    def list_objects_v2(self, Bucket, Prefix, **kw):
        return {"Contents": [{"Key": k} for k in sorted(self.objects) if k.startswith(Prefix)], "IsTruncated": False}

    def delete_object(self, Bucket, Key):
        self.objects.pop(Key, None)


@pytest.fixture(autouse=True)
def _fresh_graph():
    chaos.deactivate()
    yield
    chaos.deactivate()
    tpw.clear_graph()
    jpw.clear_graph()


def _backend(pw, kind: str, store: str):
    if kind == "filesystem":
        return pw.persistence.Backend.filesystem(store)
    if kind == "mock":
        return pw.persistence.Backend.mock({})
    return pw.persistence.Backend.s3("s3://bucket/pstore", _client=MemS3())


def _paced_commit(ctx) -> None:
    """Commit, then wait (2 s at most) until the engine took the commit:
    every row is an epoch of its own however loaded the machine is."""
    ctx.commit()
    deadline = time.monotonic() + 2.0
    while ctx.session.pending() and time.monotonic() < deadline:
        time.sleep(0.002)


def _build_wordcount(pw, out: str, backend):
    """One epoch per input row: clean runs are deterministic, so crash runs
    compare byte for byte."""
    conn = sys.modules[pw.__name__ + ".io._connector"]

    class S(pw.Schema):
        word: str

    def reader(ctx):
        for i, w in enumerate(WORDS):
            if i < int(ctx.offsets.get("pos", 0)):
                continue
            ctx.insert({"word": w}, offsets={"pos": i + 1})
            _paced_commit(ctx)

    t = conn.input_table_from_reader(S, reader, name="wsrc", persistent_id="w", supports_offsets=True,
                                     autocommit_duration_ms=10)
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pw.io.jsonlines.write(c, out)
    return pw.persistence.Config.simple_config(backend)


def _clean_run(pw, folder) -> str:
    out = str(folder / f"clean_{pw.__name__}.jsonl")
    cfg = _build_wordcount(pw, out, _backend(pw, "filesystem", str(folder / f"clean_{pw.__name__}")))
    pw.run(monitoring_level="none", persistence_config=cfg)
    pw.clear_graph()
    with open(out) as f:
        return f.read()


@pytest.fixture(scope="module")
def clean(tmp_path_factory) -> str:
    """The reference's clean output; the port's clean run must equal it."""
    folder = tmp_path_factory.mktemp("clean")
    ref = _clean_run(jpw, folder)
    assert ref and _net(ref) == FINAL
    return ref


def _net(text: str) -> dict:
    state: dict = {}
    for line in text.splitlines():
        rec = json.loads(line)
        if rec["diff"] > 0:
            state[rec["word"]] = rec["n"]
        else:
            state.pop(rec["word"], None)
    return state


def _supervised(pw, cfg, **kw):
    pw.run(monitoring_level="none", persistence_config=cfg,
           recovery=Recovery(max_restarts=3, backoff=RetryPolicy(first_delay_ms=1, jitter_ms=0, sleep=lambda s: None)),
           **kw)


def test_clean_run_matches_reference_byte_for_byte(tmp_path, clean):
    assert _clean_run(tpw, tmp_path) == clean


@pytest.mark.parametrize("threads", [1, 4], ids=["one_worker", "four_workers"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("backend", ["filesystem", "mock", "s3"])
def test_supervised_recovery_byte_identical(tmp_path, monkeypatch, clean, backend, depth, threads):
    """A raise while an epoch's DATA records are appended (no KIND_FEED
    yet: recovery trims and re-reads); the supervised restart's output is
    the clean run's, byte for byte."""
    monkeypatch.setenv("PATHWAY_THREADS", str(threads))
    out = str(tmp_path / "chaos.jsonl")
    cfg = _build_wordcount(tpw, out, _backend(tpw, backend, str(tmp_path / "store")))
    chaos.activate([{"site": "persistence.append_data", "hit": 5, "action": "raise"}])
    _supervised(tpw, cfg, pipeline_depth=depth)
    with open(out) as f:
        got = f.read()
    assert got == clean


@pytest.mark.parametrize(
    "rule,depth",
    [({"site": "persistence.before_advance", "time": 3, "action": "raise"}, 1),
     ({"site": "engine.before_stage_commit", "time": 3, "action": "raise"}, 1),
     ({"site": "engine.before_stage_commit", "time": 3, "action": "raise"}, 2),
     ({"site": "engine.after_stage_commit", "time": 3, "action": "raise"}, 2)],
    ids=["before_advance", "before_stage_commit", "before_stage_commit_depth2", "after_stage_commit_depth2"],
)
def test_crash_sites_recover(tmp_path, clean, rule, depth):
    out = str(tmp_path / "chaos.jsonl")
    cfg = _build_wordcount(tpw, out, _backend(tpw, "filesystem", str(tmp_path / "store")))
    chaos.activate([dict(rule)])
    _supervised(tpw, cfg, pipeline_depth=depth)
    with open(out) as f:
        got = f.read()
    assert got == clean


def test_post_flush_pre_marker_window_is_idempotent(tmp_path, clean):
    out = str(tmp_path / "chaos.jsonl")
    cfg = _build_wordcount(tpw, out, _backend(tpw, "filesystem", str(tmp_path / "store")))
    chaos.activate([{"site": "engine.after_sink_flush", "time": 4, "action": "raise"}])
    _supervised(tpw, cfg)
    with open(out) as f:
        got = f.read()
    assert _net(got) == _net(clean) == FINAL
    assert set(clean.splitlines()) <= set(got.splitlines())  # nothing lost


KILL_PROGRAM = textwrap.dedent(
    """
    import os, time
    import pathway_tpu_torch as pw
    from pathway_tpu_torch.io._connector import input_table_from_reader

    WORDS = {words!r}

    class S(pw.Schema):
        word: str

    def reader(ctx):
        for i, w in enumerate(WORDS):
            if i < int(ctx.offsets.get("pos", 0)):
                continue
            ctx.insert({{"word": w}}, offsets={{"pos": i + 1}})
            ctx.commit()
            deadline = time.monotonic() + 2.0
            while ctx.session.pending() and time.monotonic() < deadline:
                time.sleep(0.002)

    t = input_table_from_reader(S, reader, name="wsrc", persistent_id="w", supports_offsets=True,
                                autocommit_duration_ms=10)
    c = t.groupby(pw.this.word).reduce(pw.this.word, n=pw.reducers.count())
    pw.io.jsonlines.write(c, os.environ["KP_OUT"])
    pw.run(monitoring_level="none", recovery=True, persistence_config=pw.persistence.Config.simple_config(
        pw.persistence.Backend.filesystem(os.environ["KP_STORE"])))
    """
)


def _spawn(tmp_path, out: str, chaos_spec: str | None):
    env = {k: v for k, v in os.environ.items() if k != "PATHWAY_CHAOS"}
    env.update(KP_OUT=out, KP_STORE=str(tmp_path / "store"), PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    if chaos_spec is not None:
        env["PATHWAY_CHAOS"] = chaos_spec
    prog = tmp_path / "kp.py"
    prog.write_text(KILL_PROGRAM.format(words=WORDS))
    return subprocess.Popen([sys.executable, str(prog)], env=env, cwd=str(tmp_path), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)


def test_sigkill_mid_epoch_byte_identical(tmp_path, clean):
    """The chaos harness SIGKILLs a child while an epoch's DATA records are
    appended; a respawn on the same store resumes, and the two runs' sink
    outputs together are the reference's clean output."""
    out1 = str(tmp_path / "k1.jsonl")
    p1 = _spawn(tmp_path, out1, json.dumps({"site": "persistence.append_data", "hit": 5, "action": "kill"}))
    try:
        p1.wait(timeout=60)
    finally:
        if p1.poll() is None:
            p1.kill()
    assert p1.returncode == -signal.SIGKILL, p1.returncode
    out2 = str(tmp_path / "k2.jsonl")
    p2 = _spawn(tmp_path, out2, None)
    try:
        _, err = p2.communicate(timeout=60)
        assert p2.returncode == 0, err[-3000:]
    finally:
        if p2.poll() is None:
            p2.kill()
    with open(out1) as f:
        part1 = f.read()
    with open(out2) as f:
        part2 = f.read()
    assert part1 and part1 + part2 == clean
