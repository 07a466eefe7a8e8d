"""Run a user program in graph-build-only mode and analyze the result.

Backs the ``python -m pathway_tpu_torch analyze <program>`` subcommand: the program
is executed with ``PATHWAY_ANALYZE_ONLY=1`` set, which makes
``pw.run()`` / ``pw.run_all()`` return before building sinks or starting
any connector thread — so the full parse graph exists, but no data
flows and no external system is touched."""

from __future__ import annotations

import os
import runpy
import sys
import traceback

ANALYZE_ONLY_ENV = "PATHWAY_ANALYZE_ONLY"

#: exit codes of ``pathway analyze``
EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_PROGRAM_ERROR = 3


def analyze_program(
    program: str,
    argv: list[str] | None = None,
    *,
    as_json: bool = False,
    strict_warnings: bool = False,
    fail_on: str = "error",
    deep: bool = False,
    out=None,
) -> int:
    """Execute ``program`` (a .py path) in analyze-only mode, run the
    verifier over the graph it builds, print diagnostics, and return the
    process exit code.

    ``fail_on`` picks the exit-code threshold: ``"error"`` (default)
    exits 1 only on error-severity findings, ``"warn"`` on warnings
    too. ``strict_warnings`` is the deprecated spelling of
    ``fail_on="warn"``. ``deep=True`` adds the op-level pass
    (PWL017-PWL020)."""
    from ..internals.parse_graph import G, clear_graph
    from . import analyze
    from .diagnostics import Severity, render_human, render_json

    if fail_on not in ("warn", "error"):
        raise ValueError(f"fail_on={fail_on!r}: expected 'warn' or 'error'")

    out = out if out is not None else sys.stdout
    clear_graph()
    old_env = os.environ.get(ANALYZE_ONLY_ENV)
    old_argv = sys.argv
    os.environ[ANALYZE_ONLY_ENV] = "1"
    sys.argv = [program, *(argv or [])]
    try:
        try:
            runpy.run_path(program, run_name="__main__")
        except SystemExit:
            pass  # programs may sys.exit() after pw.run()
        except BaseException:
            print(f"analyze: program {program!r} failed while building its graph:",
                  file=sys.stderr)
            traceback.print_exc()
            return EXIT_PROGRAM_ERROR
    finally:
        sys.argv = old_argv
        if old_env is None:
            os.environ.pop(ANALYZE_ONLY_ENV, None)
        else:
            os.environ[ANALYZE_ONLY_ENV] = old_env

    stats: dict = {}
    diags = analyze(G, deep=deep, stats=stats)
    rendered = (
        render_json(diags, suppressed=stats.get("suppressed", 0))
        if as_json
        else render_human(diags)
    )
    print(rendered, file=out)
    worst_rank = 1 if (strict_warnings or fail_on == "warn") else 0
    if any(d.severity.rank <= worst_rank for d in diags):
        return EXIT_FINDINGS
    return EXIT_CLEAN
