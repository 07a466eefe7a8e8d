"""pw.run / pw.run_all.

The port's copy of the reference's ``internals/run.py``: build the sinks
and subscriptions of the global parse graph ``G`` and run the engine to
completion, on ``PATHWAY_THREADS`` engine workers in this process.

The run options of planes this package does not hold yet raise
``NotImplementedError`` naming the ROADMAP item that brings them, whether
they come as keywords or as ``PATHWAY_*`` environment variables; none is
silently ignored.

The observability planes run with the reference's precedence (an explicit
keyword wins over its ``PATHWAY_*`` variable; ``False`` turns an
env-enabled plane off for the run) and are written into
``G.run_context`` under the reference's keys:

- ``tracing=`` / ``PATHWAY_TRACING``: request-journey spans for the run;
  the trace store is dumped at the end (``RunResult.trace_dumps``);
- ``chip_ledger=`` / ``PATHWAY_CHIP_LEDGER``: device-seconds per plane
  account (``internals/chip_ledger.py``);
- ``freshness=`` / ``PATHWAY_FRESHNESS``: the freshness plane, with an
  optional SLO (``"slo=250ms"``);
- ``watchdog=`` / ``PATHWAY_WATCHDOG``: the health watchdog thread; its
  final verdict is ``RunResult.health``;
- ``with_http_server=`` (``monitoring_http_port=``, else
  ``PATHWAY_MONITORING_HTTP_PORT``, else 20000 + process id): ``/metrics``
  and ``/status`` for the run (``RunResult.monitoring_http_port``);
- ``monitoring_level=``: the ``rich`` dashboard.

The flight recorder is always on; a failing run dumps it
(``RunResult.flight_recorder_dumps`` lists dumps written during a run).
``profile=`` / ``PATHWAY_PROFILE``, ``PATHWAY_JOURNAL_DIR``,
``PATHWAY_TELEMETRY_SERVER`` / ``PATHWAY_MONITORING_SERVER`` and
``license_key`` / ``PATHWAY_LICENSE_KEY`` still raise: the profiler, the
metrics journal, the OTLP exporter and licensing are the rest of ROADMAP
Queue A item 3.

``mesh=`` (or ``PATHWAY_MESH``) shards the device-backed indexes over a
mesh's data axis: the spec is parsed into ``G.run_context["mesh_axes"]``
first (None when malformed; the resolve then raises), and a ``mesh=``
argument is resolved and installed as the run-scoped mesh
(``parallel.mesh.active_mesh``) for the run only, so an enclosing
``use_mesh`` survives a run without one. ``PATHWAY_MESH`` is read when an
index is built. ``"auto"`` arms the elastic plane and raises.

``decode=`` (or ``PATHWAY_DECODE``) is parsed into
``G.run_context["decode"]`` (the config's knobs, None when off or
malformed), and a ``decode=`` argument is installed as the run-scoped
decode config (``decode.config.active_decode``) for the run only, so an
enclosing ``use_decode`` survives the run: a ``DecodeEngine`` built during
the run without a config takes it. A malformed ``decode=`` raises.
``PATHWAY_DECODE`` is read when an engine is built.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
from dataclasses import dataclass, field
from typing import Any

from ..decode.config import parse_decode_spec, use_decode
from ..parallel.mesh import parse_mesh_spec, resolve_mesh, use_mesh
from ..parallel.sharding import CLUSTER_ITEM
from . import flight_recorder
from .graph_runner import GraphRunner
from .parse_graph import G

logger = logging.getLogger(__name__)

# ROADMAP Queue A items of the planes a run option belongs to
_PLANES = "ROADMAP Queue A item 3 (the profiler, metrics journal, telemetry exporter and licensing)"
_TIERS = "ROADMAP Queue A item 4 (tiered and tenant indexes)"
_MULTI = CLUSTER_ITEM
_DURABLE = "ROADMAP Queue A item 6 (persistence, recovery and the epoch pipeline)"
_VERIFIER = "ROADMAP Queue A item 10 (the deep verifier)"

# keyword -> (value that leaves the plane off, ROADMAP item)
_UNPORTED_KWARGS = {
    "profile": (None, _PLANES),
    "persistence_config": (None, _DURABLE),
    "recovery": (None, _DURABLE),
    "ingest_workers": (None, _DURABLE),
    "elastic": (None, _MULTI),
    "cluster_accept_timeout": (None, _MULTI),
    "cluster_hello_timeout": (None, _MULTI),
    "cluster_lease_ms": (None, _MULTI),
    "cluster_partial_restarts": (None, _MULTI),
    "index_tiers": (None, _TIERS),
    "tenancy": (None, _TIERS),
    "analysis": (None, _VERIFIER),
    "license_key": (None, _PLANES),
}

# environment variable -> (values that leave the plane off, ROADMAP item)
_UNPORTED_ENV = {
    "PATHWAY_MONITORING_SERVER": ((), _PLANES),
    "PATHWAY_PROFILE": ((), _PLANES),
    "PATHWAY_JOURNAL_DIR": ((), _PLANES),
    "PATHWAY_TELEMETRY_SERVER": ((), _PLANES),
    "PATHWAY_LICENSE_KEY": ((), _PLANES),
    "PATHWAY_REPLAY_STORAGE": ((), _DURABLE),
    "PATHWAY_PIPELINE_DEPTH": (("1",), _DURABLE),
    "PATHWAY_INGEST_WORKERS": (("0",), _DURABLE),
    "PATHWAY_PROCESSES": (("1",), _MULTI),
    "PATHWAY_ELASTIC": (("0", "false", "no", "off"), _MULTI),
    "PATHWAY_INDEX_TIERS": ((), _TIERS),
    "PATHWAY_TENANCY": (("0", "false", "no", "off"), _TIERS),
    "PATHWAY_ANALYSIS": (("off",), _VERIFIER),
}


@dataclass
class RunResult:
    """What ``pw.run`` hands back after the graph completes.

    ``monitoring_http_port`` is the port the /metrics server bound
    (``monitoring_http_port=0`` and the ephemeral fallback resolve here);
    None without ``with_http_server``. ``flight_recorder_dumps`` lists the
    black-box dumps written during the run. ``serving_http_ports`` lists
    the ports the run's serving endpoints bound. ``trace_dumps`` lists the
    request-trace files the run wrote (``tracing=True``). ``health`` is the
    watchdog's final verdict when the run had ``watchdog=`` on."""

    monitoring_http_port: int | None = None
    flight_recorder_dumps: list[str] = field(default_factory=list)
    serving_http_ports: list[int] = field(default_factory=list)
    trace_dumps: list[str] = field(default_factory=list)
    health: dict | None = None


def unported_options(kwargs: dict[str, Any], environ=None) -> list[str]:
    """Messages for every run option in ``kwargs`` or ``environ`` whose
    plane is not ported (an option at its "off" value passes)."""
    environ = os.environ if environ is None else environ
    out = []
    for name, spec in (("pw.run(mesh=...)", kwargs.get("mesh")), ("PATHWAY_MESH", environ.get("PATHWAY_MESH"))):
        try:
            auto = bool((parse_mesh_spec(spec) or {}).get("auto"))
        except ValueError:
            auto = False  # a malformed spec fails when the run resolves it
        if auto:
            out.append(f"{name} 'auto' arms the elastic plane: it needs {_MULTI}")
    for name, value in kwargs.items():
        if name == "pipeline_depth":
            if value is not None and int(value) > 1:
                out.append(f"pw.run(pipeline_depth={value}) needs {_DURABLE}")
        elif name in _UNPORTED_KWARGS:
            off, item = _UNPORTED_KWARGS[name]
            if value is not off and value != off:
                out.append(f"pw.run({name}=...) needs {item}")
    for name, (off, item) in _UNPORTED_ENV.items():
        value = environ.get(name)
        if value and value.strip().lower() not in off:
            out.append(f"{name}={value} needs {item}")
    return out


def _threads() -> int:
    value = os.environ.get("PATHWAY_THREADS") or "1"
    try:
        return max(1, int(value))
    except ValueError as exc:
        raise ValueError(f"PATHWAY_THREADS={value!r} is not a worker count") from exc


def run(
    *,
    debug: bool = False,
    runtime_typechecking: bool = True,
    terminate_on_error: bool = True,
    pipeline_depth: int | None = None,
    mesh: Any = None,
    decode: Any = None,
    monitoring_level: Any = None,
    with_http_server: bool = False,
    monitoring_http_port: int | None = None,
    tracing: Any = None,
    watchdog: Any = None,
    chip_ledger: Any = None,
    freshness: Any = None,
    **kwargs: Any,
) -> RunResult:
    """Execute all registered outputs/subscriptions to completion (static
    sources) or until all streaming connectors close, on
    ``PATHWAY_THREADS`` engine workers (threads of this process).

    ``terminate_on_error``: True aborts the run at the first failing
    row; False gives failing rows the ERROR value and an entry in the
    error log. ``debug`` and ``runtime_typechecking`` are accepted as
    the reference accepts them. Every other keyword of the reference's
    ``pw.run`` belongs to a plane not yet ported and raises
    ``NotImplementedError`` unless it is at its "off" value.

    ``tracing``, ``chip_ledger``, ``freshness`` (``True`` or a spec such as
    ``"slo=250ms"``), ``watchdog`` (``True`` or a spec such as
    ``"interval=0.5,breach_for=3"``), ``with_http_server`` with
    ``monitoring_http_port`` (0: an ephemeral port), and
    ``monitoring_level``: the observability planes (module docstring).

    ``mesh``: a ``DeviceMesh`` or a spec (``8``, ``"4x2"``, ...; it
    resolves on the cards) that the device-backed indexes built in this run
    shard over.

    ``decode``: a ``DecodeConfig`` or a spec (``True``, ``"pages=256,
    cache=on,chunk=64"``, a dict, ...) that the decode engines built in
    this run without a config take."""
    unknown = sorted(set(kwargs) - set(_UNPORTED_KWARGS))
    if unknown:
        raise TypeError(f"pw.run() got unexpected keyword arguments {unknown}")
    planes = dict(with_http_server=with_http_server, monitoring_http_port=monitoring_http_port,
                  monitoring_level=monitoring_level, tracing=tracing, watchdog=watchdog, chip_ledger=chip_ledger,
                  freshness=freshness)
    missing = unported_options({**kwargs, "pipeline_depth": pipeline_depth, "mesh": mesh})
    if missing:
        raise NotImplementedError("; ".join(missing))
    try:
        mesh_axes = parse_mesh_spec(mesh if mesh is not None else (os.environ.get("PATHWAY_MESH") or None))
    except ValueError:
        mesh_axes = None
    decode_cfg = parse_decode_spec(decode)  # a malformed decode= raises here
    if decode is None:
        try:
            decode_cfg = parse_decode_spec(os.environ.get("PATHWAY_DECODE") or None)
        except ValueError:
            decode_cfg = None  # active_decode() treats it as off too
    resolved = _resolve_planes(**planes)
    G.run_context = {
        "mesh_axes": mesh_axes,
        "decode": decode_cfg.as_dict() if decode_cfg is not None else None,
        **resolved["context"],
    }
    run_mesh = resolve_mesh(mesh)
    with contextlib.ExitStack() as scope:
        if run_mesh is not None:
            scope.enter_context(use_mesh(run_mesh))
        if decode is not None and decode_cfg is not None:
            scope.enter_context(use_decode(decode_cfg))
        return _run_observed(terminate_on_error, planes, resolved)


def _resolve_planes(*, with_http_server, monitoring_http_port, monitoring_level, tracing, watchdog, chip_ledger,
                    freshness) -> dict:
    """Resolve the observability options against their variables, as the
    reference does; a malformed watchdog or freshness spec raises here,
    before any sink is built."""
    from ..freshness.plane import parse_freshness_spec
    from .chip_ledger import chip_ledger_enabled
    from .ledger import parse_watchdog_spec
    from .monitoring import MonitoringLevel

    tracing_on = (
        bool(tracing)
        if tracing is not None
        else str(os.environ.get("PATHWAY_TRACING", "")).strip().lower() in ("1", "true", "yes", "on")
    )
    wd_raw = watchdog if watchdog is not None else (os.environ.get("PATHWAY_WATCHDOG") or None)
    watchdog_cfg = parse_watchdog_spec(wd_raw)
    freshness_cfg = parse_freshness_spec(
        freshness if freshness is not None else (os.environ.get("PATHWAY_FRESHNESS") or None)
    )
    chip_on = bool(chip_ledger) if chip_ledger is not None else chip_ledger_enabled()
    level = MonitoringLevel.coerce(monitoring_level)
    return {
        "tracing": tracing_on,
        "watchdog": watchdog_cfg,
        "freshness": freshness_cfg,
        "level": level,
        "context": {
            "monitoring_level": monitoring_level,
            "with_http_server": bool(with_http_server),
            "tracing": tracing_on,
            "profile": False,
            "watchdog": watchdog_cfg is not None,
            "chip_ledger": chip_on,
            "freshness": freshness_cfg.as_dict() if freshness_cfg is not None else None,
            "watchdog_freshness": "freshness_" in str(wd_raw or ""),
        },
    }


def _run_observed(terminate_on_error: bool, planes: dict, resolved: dict) -> RunResult:
    """Install the observability planes for the run, run the graph, and
    restore every plane's previous setting at the end (nested runs in one
    process do not leak them)."""
    from .. import tracing as _tracing
    from ..freshness.plane import FRESHNESS
    from ..io.http._server import _BOUND_PORTS
    from .chip_ledger import CHIP_LEDGER
    from .monitoring import MonitoringLevel, monitor_stats

    result = RunResult()
    dumps_before = len(flight_recorder.RECORDER._dumped_paths)
    ports_before = len(_BOUND_PORTS)
    prev_tracing = _tracing.set_tracing_enabled(resolved["tracing"])
    prev_chip = CHIP_LEDGER._override
    CHIP_LEDGER.set_enabled(bool(planes["chip_ledger"]) if planes["chip_ledger"] is not None else None)
    prev_fresh = FRESHNESS._override
    FRESHNESS.set_enabled((resolved["freshness"] is not None) if planes["freshness"] is not None else None)
    FRESHNESS.configure(resolved["freshness"])
    watchdog = None
    if resolved["watchdog"] is not None:
        from .ledger import HealthWatchdog

        watchdog = HealthWatchdog(rules=resolved["watchdog"]["rules"], interval_s=resolved["watchdog"]["interval_s"])
        watchdog.start()
    level = resolved["level"].resolve()
    with_http = bool(planes["with_http_server"])
    need_monitor = with_http or level is not MonitoringLevel.NONE
    mon_ctx = (
        monitor_stats(level, process_id=int(os.environ.get("PATHWAY_PROCESS_ID", "0") or 0),
                      screen=sys.stderr.isatty())
        if need_monitor
        else contextlib.nullcontext(None)
    )
    try:
        with mon_ctx as monitor:
            http_server = None
            if with_http:
                from .http_monitoring import MonitoringHttpServer

                http_server = MonitoringHttpServer(monitor, port=planes["monitoring_http_port"])
                http_server.start()
                result.monitoring_http_port = http_server.port
                monitor.http_port = http_server.port
            try:
                _run_graph(terminate_on_error, monitor.update if monitor is not None else None)
            except Exception as exc:
                # unsupervised crash: keep the last engine events
                path = flight_recorder.dump("crash", exc)
                if path:
                    logger.error("flight recorder dump written to %s", path)
                raise
            finally:
                if http_server is not None:
                    http_server.stop()
    finally:
        if watchdog is not None:
            watchdog.stop()
            # one final evaluation, so a run shorter than the interval still
            # leaves a verdict
            watchdog.evaluate_once()
            result.health = watchdog.verdict()
        result.flight_recorder_dumps = list(flight_recorder.RECORDER._dumped_paths[dumps_before:])
        if resolved["tracing"]:
            path = _tracing.TRACE_STORE.dump()
            if path:
                result.trace_dumps.append(path)
        _tracing.set_tracing_enabled(prev_tracing)
        CHIP_LEDGER.set_enabled(prev_chip)
        FRESHNESS.set_enabled(prev_fresh)
    result.serving_http_ports = sorted(set(_BOUND_PORTS[ports_before:]))
    return result


def _run_graph(terminate_on_error: bool, monitoring_callback=None) -> None:
    runner = GraphRunner(n_workers=_threads())
    runner.engine.terminate_on_error = terminate_on_error
    for r in runner._replicas:
        r.engine.terminate_on_error = terminate_on_error
    for table, sink in list(G.outputs):
        sink_builder = sink.get("build")
        if sink_builder is not None:
            sink_builder(runner, table)
    for spec in list(G.subscriptions):
        runner.subscribe(
            spec["table"],
            on_change=spec.get("on_change"),
            on_time_end=spec.get("on_time_end"),
            on_end=spec.get("on_end"),
        )
    runner.run(monitoring_callback=monitoring_callback)


def run_all(**kwargs: Any) -> RunResult:
    return run(**kwargs)
