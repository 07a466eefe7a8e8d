"""The port's ``argparse`` command line (``python -m pathway_tpu_torch``)
against the reference's ``click`` CLI, on the CPU (``tests/test_cli.py``'s
and the blackbox / trace / perf / top / freshness / doctor / profile
cases of the reference's tests). The port's CLI runs in a subprocess (one
interpreter runs a list of commands through ``cli.main``, so the torch
import is paid once); the reference's through ``CliRunner``, on the same
flight-recorder dumps, trace dumps, journals and snapshots.

Tolerances: exit codes, stdout and the ``Error:`` line of stderr equal."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
from click.testing import CliRunner

from pathway_tpu.cli import cli as jcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUNNER = r"""
import contextlib, io, json, sys
from pathway_tpu_torch.cli import main
out = []
for argv in json.loads(sys.argv[1]):
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        try:
            rc = main(argv)
        except SystemExit as exc:
            rc = exc.code if isinstance(exc.code, int) else 2
        except NotImplementedError as exc:
            rc, _ = 1, e.write(f"NotImplementedError: {exc}\n")
    out.append({"rc": rc, "stdout": o.getvalue(), "stderr": e.getvalue()})
print(json.dumps(out))
"""


def _port(cmds: list[list[str]], env: dict | None = None) -> list[dict]:
    full = dict(os.environ, **(env or {}))
    full["PYTHONPATH"] = REPO + os.pathsep + full.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _RUNNER, json.dumps(cmds)], env=full, capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _ref(args: list[str], env: dict | None = None) -> dict:
    r = CliRunner().invoke(jcli, args, env=env)
    return {"rc": r.exit_code, "stdout": r.stdout, "stderr": r.stderr}


def _same(got: dict, want: dict) -> None:
    assert (got["rc"], got["stdout"]) == (want["rc"], want["stdout"])
    errors = lambda s: [line for line in s.splitlines() if line.startswith("Error:")]  # noqa: E731
    assert errors(got["stderr"]) == errors(want["stderr"])


@pytest.fixture()
def dumps(tmp_path, monkeypatch):
    """Two flight-recorder dumps and one trace dump, written by the port."""
    from pathway_tpu_torch import tracing as ttr
    from pathway_tpu_torch.internals import flight_recorder as fr

    bb, traces = tmp_path / "blackbox", tmp_path / "traces"
    monkeypatch.setenv("PATHWAY_FLIGHT_RECORDER_DIR", str(bb))
    fr.RECORDER.clear()
    for epoch in range(3):
        fr.record("epoch.begin", t=epoch)
        fr.record("epoch.advance", t=epoch)
    a = fr.dump("crash", RuntimeError("boom"))
    fr.record("connector.failure", name="src")
    b = fr.dump("worker.death")
    prev = ttr.set_tracing_enabled(True)
    ttr.TRACE_STORE.reset()
    try:
        for stage in ("admission", "queue"):
            with ttr.span("request", new_trace=True):
                with ttr.span(stage):
                    pass
        path = ttr.TRACE_STORE.dump(str(traces))
    finally:
        ttr.set_tracing_enabled(prev)
        ttr.TRACE_STORE.reset()
        fr.RECORDER.clear()
    trace_id = json.loads(open(path).read())["exemplars"][0]["trace_id"]
    return {"bb": str(bb), "a": a, "b": b, "traces": str(traces), "trace": trace_id, "tmp": tmp_path}


def test_help_runs_and_lists_the_reference_commands():
    full = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "pathway_tpu_torch", "--help"], env=full, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for command in ("spawn", "spawn-from-env", "analyze", "profile", "doctor", "blackbox", "trace", "perf", "top",
                    "freshness"):
        assert command in proc.stdout
        assert command in jcli.commands


def test_blackbox_and_trace_commands_match_the_reference(dumps):
    d = dumps
    cmds = [
        ["blackbox", "list", "--dir", d["bb"]],
        ["blackbox", "list", "--dir", str(d["tmp"] / "nowhere")],
        ["blackbox", "show", d["a"]],
        ["blackbox", "show", "--tail-epochs", "1", d["b"]],
        ["blackbox", "show", str(d["tmp"] / "missing.json")],
        ["blackbox", "diff", d["a"], d["b"]],
        ["trace", "list", "--dir", d["traces"]],
        ["trace", "show", "--dir", d["traces"], "--no-blackbox", d["trace"][:12]],
        ["trace", "show", "--dir", d["traces"], "--no-blackbox", "ffff"],
        ["trace", "slow", "--dir", d["traces"], "--top", "1"],
        ["trace", "slow", "--dir", str(d["tmp"] / "nowhere")],
    ]
    got = _port(cmds)
    for argv, g in zip(cmds, got):
        _same(g, _ref(argv))
    assert got[0]["stdout"].count("reason=") == 2 and got[8]["rc"] == 1


def _journal(tmp_path):
    from pathway_tpu_torch.internals.chip_ledger import ChipTimeLedger
    from pathway_tpu_torch.perf.journal import MetricsJournal

    ledger = ChipTimeLedger()
    ledger.set_enabled(True)
    ledger.book("encode", 0.08)
    ledger.book("index.search", 0.02)
    chip = ledger.snapshot(0.2)
    j = MetricsJournal(str(tmp_path / "journal"))
    j.append("sample", {"chip": chip, "hbm": {"index.hot": {"bytes": 4096, "high_water_bytes": 8192}},
                        "freshness": {"lag": {"p50_ms": 12.0, "p99_ms": 40.0, "ewma_ms": 15.0}, "slo_ms": 250.0}})
    j.append("bench", {"suite": "smoke", "records": [{"metric": "ingest_eps", "value": 1000.0, "unit": "rows/s"}],
                       "headline": {"metric": "p50_ms", "value": 10.0, "unit": "ms"}})
    j.close()
    snap = tmp_path / "a.json"
    snap.write_text(json.dumps({"n": 1, "cmd": "x", "rc": 0, "parsed": {}, "tail": "\n".join(
        json.dumps({"metric": m, "value": v, "unit": u}) for m, v, u in (("ingest_eps", 800.0, "rows/s"),
                                                                        ("p50_ms", 9.0, "ms")))}))
    return str(tmp_path / "journal"), str(snap)


def test_perf_top_and_freshness_commands_match_the_reference(tmp_path):
    journal, snap = _journal(tmp_path)
    empty = str(tmp_path / "empty")
    cmds = [
        ["perf", "snapshot", "--journal", journal],
        ["perf", "snapshot", "--journal", journal, "-o", str(tmp_path / "b.json")],
        ["perf", "snapshot", "--journal", empty],
        ["top", "--once", "--journal", journal],
        ["top", "--once", "--journal", empty],
        ["freshness", "--journal", journal],
        ["freshness", "--journal", journal, "--json"],
        ["freshness", "--journal", empty],
    ]
    got = _port(cmds)
    for argv, g in zip(cmds, got):
        _same(g, _ref(argv))
    assert got[0]["rc"] == 0 and got[3]["rc"] == 0 and got[4]["rc"] == 1
    # the diff of the written snapshot against another
    diff = ["perf", "diff", snap, str(tmp_path / "b.json")]
    _same(_port([diff])[0], _ref(diff))


_PROGRAM = """
import os, sys
sys.path.insert(0, {repo!r})
import pathway_tpu_torch as pw
t = pw.debug.table_from_markdown('''
  | a
1 | 1
2 | 2
''')
pw.io.null.write(t.select(b=pw.this.a * 2))
with open({out!r}, "a") as fh:
    keys = ("PATHWAY_THREADS", "PATHWAY_PROCESSES", "PATHWAY_PROCESS_ID")
    fh.write(",".join(os.environ.get(k, "") for k in keys) + chr(10))
pw.run()
sys.exit(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
"""


def _program(tmp_path):
    prog, seen = tmp_path / "prog.py", tmp_path / "env.txt"
    prog.write_text(_PROGRAM.format(repo=REPO, out=str(seen)))
    return str(prog), seen


def test_spawn_runs_the_program_with_the_topology_env(tmp_path):
    prog, seen = _program(tmp_path)
    got = _port([["spawn", "--threads", "2", prog], ["spawn", prog, "3"]])
    assert [g["rc"] for g in got] == [0, 3]  # the child's exit code comes back
    assert seen.read_text().splitlines() == ["2,1,0", "1,1,0"]


def test_profile_and_doctor_run_the_program(tmp_path):
    prog, _ = _program(tmp_path)
    trace = tmp_path / "trace.json"
    got = _port([["profile", "-o", str(trace), prog], ["doctor", "--json", prog], ["doctor", prog, "3"]])
    assert got[0]["rc"] == 0 and "perfetto" in got[0]["stderr"].lower()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e["ph"] == "X" and e.get("cat") == "operator" for e in events)
    verdict = json.loads(got[1]["stdout"])
    assert got[1]["rc"] == {"green": 0, "yellow": 1, "red": 2}[verdict["status"]]
    assert got[2]["rc"] == 3 and "doctor: program exited with status 3" in got[2]["stderr"]


def test_unported_commands_name_their_items(tmp_path):
    """``analyze`` of a missing program exits 3 as the reference's does
    (the command came with the verifier). ``spawn --processes 2`` runs the
    program in two processes of one cluster, and ``spawn-from-env`` without
    ``PATHWAY_SPAWN_ARGS`` fails as the reference's does."""
    import socket

    prog, seen = _program(tmp_path)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    got = _port([["analyze", "x.py"], ["spawn-from-env"], ["spawn", "--processes", "2", "--first-port", str(port), prog]],
                env={"PATHWAY_SPAWN_ARGS": ""})
    _same(got[0], _ref(["analyze", "x.py"]))
    assert got[0]["rc"] == 3 and "failed while building its graph" in got[0]["stderr"]
    _same(got[1], _ref(["spawn-from-env"], env={"PATHWAY_SPAWN_ARGS": ""}))
    assert got[1]["rc"] == 2 and "PATHWAY_SPAWN_ARGS is not set" in got[1]["stderr"]
    assert got[2]["rc"] == 0, got[2]
    assert sorted(seen.read_text().splitlines()) == ["1,2,0", "1,2,1"]
