"""``python -m pathway_tpu_torch`` command-line interface.

The port's copy of the reference's ``cli.py``, written on ``argparse`` (no
``click`` anywhere in the port): the same commands, options and output.

- ``spawn`` runs a program as ``--processes`` OS processes with the
  worker-topology variables (``PATHWAY_THREADS``, ``PATHWAY_PROCESSES``,
  ``PATHWAY_PROCESS_ID``, ``PATHWAY_FIRST_PORT``) and a random per-cluster
  ``PATHWAY_CLUSTER_TOKEN``; process 0 coordinates the multi-process
  cluster (``parallel/multiprocess.py``). ``spawn-from-env`` re-runs it
  with the arguments in ``PATHWAY_SPAWN_ARGS``.
- ``analyze`` runs a program in analyze-only mode and verifies the graph
  it describes (``analysis/``; ``--deep`` adds PWL017–PWL020): exit 0
  clean, 1 on findings at or above ``--fail-on``, 3 when the program fails
  to build its graph.
- ``profile`` runs a program with the per-operator profiler on and writes
  its Chrome trace; ``doctor`` runs it with the health watchdog on and
  renders the verdict (exit 0 green, 1 yellow, 2 red, 3 no verdict).
- ``blackbox list|show|diff`` reads flight-recorder dumps; ``trace
  list|show|slow`` request-trace dumps; ``perf snapshot|diff`` the
  metrics journal's benchmark records; ``top`` and ``freshness`` the
  newest journal sample or a live ``/status``.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import subprocess
import sys

class CommandError(Exception):
    """A command failed: ``Error: <message>`` on stderr, exit 1."""


class UsageError(CommandError):
    """A command was called wrongly: ``Error: <message>`` on stderr, exit 2."""


def _echo(text: str = "", err: bool = False) -> None:
    stream = sys.stderr if err else sys.stdout
    stream.write(f"{text}\n")
    stream.flush()


def _program_argv(program: list[str]) -> list[str]:
    if not program:
        raise CommandError("no program given")
    return [sys.executable] + program if program[0].endswith(".py") else list(program)


def _with_package_path(env: dict) -> dict:
    """Make this package importable from the child, whose ``sys.path``
    roots at the program's directory."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else root
    return env


# ------------------------------------------------------------------ spawn


def _spawn(args) -> int:
    argv = _program_argv(args.program)
    import secrets

    env = _with_package_path(os.environ.copy())
    env["PATHWAY_THREADS"] = str(args.threads)
    env["PATHWAY_PROCESSES"] = str(args.processes)
    env["PATHWAY_FIRST_PORT"] = str(args.first_port)
    # the per-cluster secret that authenticates the worker protocol
    env.setdefault("PATHWAY_CLUSTER_TOKEN", secrets.token_hex(16))
    env["PATHWAY_SPAWN_ARGS"] = shlex.join(
        [f"--threads={args.threads}", f"--processes={args.processes}", f"--first-port={args.first_port}"]
        + (["--record"] if args.record else [])
        + ([f"--record-path={args.record_path}"] if args.record_path else [])
        + ([f"--replay-mode={args.replay_mode}"] if args.replay_mode else [])
        + list(args.program)
    )
    if args.record or args.replay_mode:
        env["PATHWAY_REPLAY_STORAGE"] = args.record_path or "./record"
        env["PATHWAY_REPLAY_MODE"] = args.replay_mode or "record"
    procs: list[subprocess.Popen] = []
    try:
        for pid in range(args.processes):
            procs.append(subprocess.Popen(argv, env={**env, "PATHWAY_PROCESS_ID": str(pid)}))
    except OSError:
        for p in procs:
            p.terminate()
        raise
    rc = 0
    try:
        for p in procs:
            code = p.wait()
            # killed by a signal: the conventional 128 + N status
            code = 128 - code if code < 0 else code
            if code and not rc:
                rc = code
    except KeyboardInterrupt:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait()
        return 130
    return rc


def _spawn_from_env(args) -> int:
    """``spawn`` with the arguments of ``PATHWAY_SPAWN_ARGS`` (what a
    spawned program finds in its environment; container deployments set it)."""
    raw = os.environ.get("PATHWAY_SPAWN_ARGS", "")
    if not raw:
        raise UsageError("PATHWAY_SPAWN_ARGS is not set")
    return main(["spawn", *shlex.split(raw)])


def _analyze(args) -> int:
    """Statically verify PROGRAM's dataflow graph without running it: the
    program executes with PATHWAY_ANALYZE_ONLY=1, so pw.run() returns
    before building sinks or starting connectors, and the verifier walks
    the graph it described."""
    from .analysis.program import analyze_program

    return analyze_program(args.program, list(args.arguments), as_json=args.as_json,
                           strict_warnings=args.strict_warnings, fail_on=args.fail_on, deep=args.deep)


# --------------------------------------------------------- profile, doctor


def _profile(args) -> int:
    argv = _program_argv(args.program)
    env = _with_package_path(os.environ.copy())
    env["PATHWAY_PROFILE"] = args.output
    rc = subprocess.call(argv, env=env)
    if rc == 0:
        _echo(f"profile written to {args.output} — load it at https://ui.perfetto.dev", err=True)
    return rc


_DOCTOR_EXIT = {"green": 0, "yellow": 1, "red": 2}


def _doctor(args) -> int:
    import tempfile

    argv = _program_argv(args.program)
    env = _with_package_path(os.environ.copy())
    if args.spec is not None:
        env["PATHWAY_WATCHDOG"] = args.spec
    elif not env.get("PATHWAY_WATCHDOG"):
        env["PATHWAY_WATCHDOG"] = "on"
    fd, out_path = tempfile.mkstemp(prefix="pathway-doctor-", suffix=".json")
    os.close(fd)
    env["PATHWAY_HEALTH_OUT"] = out_path
    try:
        rc = subprocess.call(argv, env=env)
        verdict = None
        try:
            with open(out_path, encoding="utf-8") as fh:
                raw = fh.read()
            if raw.strip():
                verdict = json.loads(raw)
        except (OSError, ValueError):
            verdict = None
    finally:
        try:
            os.unlink(out_path)
        except OSError:
            pass
    if rc != 0 or verdict is None:
        msg = (
            f"program exited with status {rc}"
            if rc != 0
            else "program left no health verdict (did it call pw.run()?)"
        )
        if args.as_json:
            _echo(json.dumps({"status": "unknown", "error": msg}))
        else:
            _echo(f"doctor: {msg}", err=True)
        return 3
    if args.as_json:
        _echo(json.dumps(verdict, indent=2, sort_keys=True))
    else:
        from .internals.ledger import render_verdict

        _echo(render_verdict(verdict))
    return _DOCTOR_EXIT.get(verdict.get("status"), 3)


# --------------------------------------------------------------- blackbox


def _blackbox_list(args) -> int:
    from .internals import flight_recorder as fr

    directory = args.directory or fr.default_dump_dir()
    paths = fr.list_dumps(directory)
    if not paths:
        _echo(f"no dumps in {directory}")
        return 0
    for path in paths:
        try:
            data = fr.load_dump(path)
        except Exception as exc:
            _echo(f"{path}  <unreadable: {exc}>")
            continue
        last = fr.last_epoch(data)
        _echo(
            f"{path}  reason={data.get('reason', '?')}"
            f" pid={data.get('pid', '?')}"
            f" events={len(data.get('events', []))}"
            + (f" last_epoch={last}" if last is not None else "")
        )
    return 0


def _blackbox_show(args) -> int:
    from .internals import flight_recorder as fr

    try:
        data = fr.load_dump(args.path)
    except Exception as exc:
        raise CommandError(f"cannot read {args.path}: {exc}")
    _echo(fr.render(data, tail_epochs=args.tail_epochs))
    return 0


def _blackbox_diff(args) -> int:
    from .internals import flight_recorder as fr

    try:
        a = fr.load_dump(args.path_a)
        b = fr.load_dump(args.path_b)
    except Exception as exc:
        raise CommandError(str(exc))
    _echo(fr.diff(a, b))
    return 0


# ------------------------------------------------------------------ trace


def _trace_dumps(directory):
    from .tracing import store as ts

    directory = directory or ts.default_trace_dir()
    return directory, ts.list_trace_dumps(directory)


def _trace_list(args) -> int:
    from .tracing import store as ts

    directory, paths = _trace_dumps(args.directory)
    if not paths:
        _echo(f"no trace dumps in {directory}")
        return 0
    for path in paths:
        try:
            data = ts.load_trace_dump(path)
        except Exception as exc:
            _echo(f"{path}  <unreadable: {exc}>")
            continue
        exemplars = data.get("exemplars", [])
        head = ""
        if exemplars:
            worst = exemplars[0]
            head = f" slowest={worst.get('trace_id', '?')[:16]} ({worst.get('wall_ms', 0.0):.1f} ms)"
        _echo(
            f"{path}  pid={data.get('pid', '?')}"
            f" worker={data.get('worker', '?')}"
            f" exemplars={len(exemplars)}"
            f" open={len(data.get('open', []))}" + head
        )
    return 0


def _collect_trace(paths, trace_id):
    """Spans for ``trace_id`` (a unique prefix is enough) across all dumps."""
    from .tracing import store as ts

    matches: dict[str, list[dict]] = {}
    for path in paths:
        try:
            data = ts.load_trace_dump(path)
        except Exception:
            continue
        buckets = [tr.get("spans", []) for tr in data.get("exemplars", [])] + [
            data.get("recent", []),
            data.get("open", []),
        ]
        for spans in buckets:
            for sp in spans:
                tid = str(sp.get("trace", ""))
                if tid.startswith(trace_id):
                    matches.setdefault(tid, []).append(sp)
    if len(matches) > 1:
        raise CommandError(f"trace id prefix {trace_id!r} is ambiguous: " + ", ".join(sorted(matches)))
    if not matches:
        return trace_id, []
    tid, spans = next(iter(matches.items()))
    seen: set[str] = set()
    unique = []
    for sp in sorted(spans, key=lambda s: float(s.get("start", 0.0))):
        sid = str(sp.get("span", ""))
        if sid in seen:
            continue
        seen.add(sid)
        unique.append(sp)
    return tid, unique


def _trace_show(args) -> int:
    from .tracing.attribution import render_waterfall

    directory, paths = _trace_dumps(args.directory)
    if not paths:
        raise CommandError(f"no trace dumps in {directory}")
    tid, spans = _collect_trace(paths, args.trace_id)
    if not spans:
        raise CommandError(f"trace {args.trace_id!r} not found in {directory}")
    events = []
    if not args.no_blackbox:
        from .internals import flight_recorder as fr

        try:
            events = fr.events_for_trace(tid)
        except Exception:
            events = []
    _echo(render_waterfall(tid, spans, blackbox_events=events))
    return 0


def _trace_slow(args) -> int:
    from .tracing import store as ts
    from .tracing.attribution import render_slow_report, slow_report

    directory, paths = _trace_dumps(args.directory)
    if not paths:
        raise CommandError(f"no trace dumps in {directory}")
    exemplars = []
    for path in paths:
        try:
            exemplars.extend(ts.load_trace_dump(path).get("exemplars", []))
        except Exception:
            continue
    if not exemplars:
        raise CommandError(f"no retained exemplars in {directory}")
    _echo(render_slow_report(slow_report(exemplars, top_n=args.top_n)))
    return 0


# ---------------------------------------------------- perf, top, freshness


def _perf_snapshot(args) -> int:
    from .perf.snapshot import build_snapshot

    try:
        snap = build_snapshot(args.directory)
    except ValueError as exc:
        raise CommandError(str(exc))
    text = json.dumps(snap, indent=2, sort_keys=True)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
        _echo(f"snapshot written to {args.output}", err=True)
    else:
        _echo(text)
    return 0


def _perf_diff(args) -> int:
    from .perf.snapshot import DEFAULT_GATE, diff_snapshots, load_snapshot, render_diff

    try:
        a = load_snapshot(args.path_a)
        b = load_snapshot(args.path_b)
    except Exception as exc:
        raise CommandError(str(exc))
    result = diff_snapshots(a, b, gate=DEFAULT_GATE if args.gate is None else args.gate)
    _echo(render_diff(result))
    return result["rc"]


def _load_view(url, directory) -> dict:
    from .perf.top import load_from_journal, load_status_from_url

    return load_status_from_url(url) if url else load_from_journal(directory)


def _top(args) -> int:
    import time

    from .perf.top import render_top

    if args.once:
        try:
            text, state = render_top(_load_view(args.url, args.directory))
        except Exception as exc:
            raise CommandError(str(exc))
        _echo(text)
        return 0 if state != "empty" else 1
    try:
        while True:
            try:
                text, _state = render_top(_load_view(args.url, args.directory))
            except Exception as exc:
                text = f"pathway top — error: {exc}"
            # clear screen + home, like watch(1)
            _echo("\033[2J\033[H" + text)
            time.sleep(max(0.1, args.interval))
    except KeyboardInterrupt:
        pass
    return 0


def _freshness(args) -> int:
    from .freshness.report import render_freshness

    try:
        data = _load_view(args.url, args.directory)
    except Exception as exc:
        raise CommandError(str(exc))
    if args.as_json:
        fresh = data.get("freshness")
        _echo(json.dumps(fresh or {}, indent=2, sort_keys=True))
        return 0 if fresh else 1
    text, state = render_freshness(data)
    _echo(text)
    return 0 if state != "empty" else 1


# ----------------------------------------------------------------- parser

_JOURNAL_DIR_HELP = "metrics journal directory [default: PATHWAY_JOURNAL_DIR]"
_TRACE_DIR_HELP = "trace dump directory [default: PATHWAY_TRACE_DIR or <tmp>/pathway-traces]"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m pathway_tpu_torch", description="pathway_tpu_torch command line.")
    sub = parser.add_subparsers(dest="command", required=True, metavar="COMMAND")

    p = sub.add_parser("spawn", help="run PROGRAM with a pathway worker topology")
    p.add_argument("--threads", "-t", type=int, default=1, help="worker threads per process (default: 1)")
    p.add_argument("--processes", "-n", type=int, default=1, help="OS processes (default: 1)")
    p.add_argument("--first-port", type=int, default=10000, help="base port for inter-process coordination")
    p.add_argument("--record", action="store_true", help="record input streams to --record-path")
    p.add_argument("--record-path", default=None, help="stream record/replay storage directory")
    p.add_argument("--replay-mode", default=None, choices=["batch", "speedrun"], help="replay recorded streams")
    p.add_argument("program", nargs=argparse.REMAINDER)
    p.set_defaults(func=_spawn)

    p = sub.add_parser("spawn-from-env", help="re-run spawn with arguments from PATHWAY_SPAWN_ARGS")
    p.set_defaults(func=_spawn_from_env)

    p = sub.add_parser("analyze", help="statically verify PROGRAM's dataflow graph without running it")
    p.add_argument("--json", dest="as_json", action="store_true", help="emit diagnostics as JSON")
    p.add_argument("--strict-warnings", action="store_true", help="deprecated alias for --fail-on=warn")
    p.add_argument("--fail-on", choices=["warn", "error"], default="error",
                   help="lowest severity that makes the exit code nonzero (default: error)")
    p.add_argument("--deep", action="store_true", help="also run the op-level deep pass (rules PWL017..PWL020)")
    p.add_argument("program")
    p.add_argument("arguments", nargs=argparse.REMAINDER)
    p.set_defaults(func=_analyze)

    p = sub.add_parser("profile", help="run PROGRAM with the per-operator profiler; write a Chrome trace")
    p.add_argument("--output", "-o", default="pathway_profile.json", help="Chrome-trace-event JSON output path")
    p.add_argument("program", nargs=argparse.REMAINDER)
    p.set_defaults(func=_profile)

    p = sub.add_parser("doctor", help="run PROGRAM with the health watchdog on and render its verdict")
    p.add_argument("--json", dest="as_json", action="store_true", help="emit the machine-readable verdict JSON")
    p.add_argument("--watchdog", dest="spec", default=None, help="watchdog spec override")
    p.add_argument("program", nargs=argparse.REMAINDER)
    p.set_defaults(func=_doctor)

    bb = sub.add_parser("blackbox", help="inspect black-box flight-recorder dumps")
    bsub = bb.add_subparsers(dest="action", required=True, metavar="ACTION")
    p = bsub.add_parser("list", help="list flight-recorder dumps, oldest first")
    p.add_argument("--dir", dest="directory", default=None,
                   help="dump directory [default: PATHWAY_FLIGHT_RECORDER_DIR or <tmp>/pathway-blackbox]")
    p.set_defaults(func=_blackbox_list)
    p = bsub.add_parser("show", help="render one dump")
    p.add_argument("--tail-epochs", type=int, default=3, help="trailing epoch transitions to highlight")
    p.add_argument("path")
    p.set_defaults(func=_blackbox_show)
    p = bsub.add_parser("diff", help="compare two dumps by event-kind counts")
    p.add_argument("path_a")
    p.add_argument("path_b")
    p.set_defaults(func=_blackbox_diff)

    tr = sub.add_parser("trace", help="inspect per-request trace dumps")
    tsub = tr.add_subparsers(dest="action", required=True, metavar="ACTION")
    p = tsub.add_parser("list", help="list trace dumps and the slowest retained trace of each")
    p.add_argument("--dir", dest="directory", default=None, help=_TRACE_DIR_HELP)
    p.set_defaults(func=_trace_list)
    p = tsub.add_parser("show", help="render one request's journey as a stage waterfall")
    p.add_argument("--dir", dest="directory", default=None, help=_TRACE_DIR_HELP)
    p.add_argument("--no-blackbox", action="store_true", help="skip flight-recorder events")
    p.add_argument("trace_id")
    p.set_defaults(func=_trace_show)
    p = tsub.add_parser("slow", help="tail-latency report of the slowest retained traces")
    p.add_argument("--dir", dest="directory", default=None, help=_TRACE_DIR_HELP)
    p.add_argument("--top", dest="top_n", type=int, default=10, help="how many traces (default: 10)")
    p.set_defaults(func=_trace_slow)

    pf = sub.add_parser("perf", help="chip-time performance snapshots and regression diffs")
    psub = pf.add_subparsers(dest="action", required=True, metavar="ACTION")
    p = psub.add_parser("snapshot", help="build a BENCH_r*-style snapshot from the journal's bench records")
    p.add_argument("--journal", dest="directory", default=None, help=_JOURNAL_DIR_HELP)
    p.add_argument("--output", "-o", default=None, help="write the snapshot JSON here instead of stdout")
    p.set_defaults(func=_perf_snapshot)
    p = psub.add_parser("diff", help="compare two snapshots per metric")
    p.add_argument("--gate", type=float, default=None, help="relative regression gate [default: 0.10]")
    p.add_argument("path_a")
    p.add_argument("path_b")
    p.set_defaults(func=_perf_diff)

    p = sub.add_parser("top", help="live chip-time view")
    p.add_argument("--url", default=None, help="monitoring server base URL (reads /status)")
    p.add_argument("--journal", dest="directory", default=None, help=_JOURNAL_DIR_HELP)
    p.add_argument("--once", action="store_true", help="render one frame and exit")
    p.add_argument("--interval", type=float, default=2.0, help="refresh interval in seconds (default: 2.0)")
    p.set_defaults(func=_top)

    p = sub.add_parser("freshness", help="where the visibility lag accrues")
    p.add_argument("--url", default=None, help="monitoring server base URL (reads /status)")
    p.add_argument("--journal", dest="directory", default=None, help=_JOURNAL_DIR_HELP)
    p.add_argument("--json", dest="as_json", action="store_true", help="emit the raw freshness block")
    p.set_defaults(func=_freshness)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "program", None) and args.program[0] == "--":
        args.program = args.program[1:]
    try:
        return int(args.func(args) or 0)
    except CommandError as exc:
        _echo(f"Error: {exc}", err=True)
        return 2 if isinstance(exc, UsageError) else 1
