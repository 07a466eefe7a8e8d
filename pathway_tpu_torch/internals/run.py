"""pw.run / pw.run_all.

The port's copy of the reference's ``internals/run.py``: build the sinks
and subscriptions of the global parse graph ``G`` and run the engine to
completion, on ``PATHWAY_THREADS`` engine workers in this process.

The run options of planes this package does not hold yet raise
``NotImplementedError`` naming the ROADMAP item that brings them, whether
they come as keywords or as ``PATHWAY_*`` environment variables; none is
silently ignored.

``mesh=`` (or ``PATHWAY_MESH``) shards the device-backed indexes over a
mesh's data axis: the spec is parsed into ``G.run_context["mesh_axes"]``
first (None when malformed; the resolve then raises), and a ``mesh=``
argument is resolved and installed as the run-scoped mesh
(``parallel.mesh.active_mesh``) for the run only, so an enclosing
``use_mesh`` survives a run without one. ``PATHWAY_MESH`` is read when an
index is built. ``"auto"`` arms the elastic plane and raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

from ..parallel.mesh import parse_mesh_spec, resolve_mesh, use_mesh
from ..parallel.sharding import CLUSTER_ITEM
from .graph_runner import GraphRunner
from .parse_graph import G

# ROADMAP Queue A items of the planes a run option belongs to
_PLANES = "ROADMAP Queue A item 3 (the index, monitoring and tracing planes)"
_TIERS = "ROADMAP Queue A item 4 (tiered and tenant indexes)"
_MULTI = CLUSTER_ITEM
_DURABLE = "ROADMAP Queue A item 6 (persistence, recovery and the epoch pipeline)"
_DECODE = "ROADMAP Queue A item 2 (the decode extensions)"
_VERIFIER = "ROADMAP Queue A item 10 (the deep verifier)"

# keyword -> (value that leaves the plane off, ROADMAP item)
_UNPORTED_KWARGS = {
    "with_http_server": (False, _PLANES),
    "monitoring_http_port": (None, _PLANES),
    "monitoring_level": (None, _PLANES),
    "profile": (None, _PLANES),
    "tracing": (None, _PLANES),
    "watchdog": (None, _PLANES),
    "chip_ledger": (None, _PLANES),
    "freshness": (None, _PLANES),
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
    "decode": (None, _DECODE),
    "analysis": (None, _VERIFIER),
    "license_key": (None, _PLANES),
}

# environment variable -> (values that leave the plane off, ROADMAP item)
_UNPORTED_ENV = {
    "PATHWAY_MONITORING_HTTP_PORT": ((), _PLANES),
    "PATHWAY_MONITORING_SERVER": ((), _PLANES),
    "PATHWAY_PROFILE": ((), _PLANES),
    "PATHWAY_TRACING": (("0", "false", "no", "off"), _PLANES),
    "PATHWAY_WATCHDOG": (("0", "false", "no", "off"), _PLANES),
    "PATHWAY_CHIP_LEDGER": (("0", "false", "no", "off"), _PLANES),
    "PATHWAY_FRESHNESS": (("0", "false", "no", "off"), _PLANES),
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
    "PATHWAY_DECODE": ((), _DECODE),
    "PATHWAY_ANALYSIS": (("off",), _VERIFIER),
}


@dataclass
class RunResult:
    """What ``pw.run`` hands back after the graph completes. The
    monitoring, tracing and health fields of the reference's result stay
    empty until those planes are ported."""

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

    ``mesh``: a ``DeviceMesh`` or a spec (``8``, ``"4x2"``, ...; it
    resolves on the cards) that the device-backed indexes built in this run
    shard over."""
    unknown = sorted(set(kwargs) - set(_UNPORTED_KWARGS))
    if unknown:
        raise TypeError(f"pw.run() got unexpected keyword arguments {unknown}")
    missing = unported_options({**kwargs, "pipeline_depth": pipeline_depth, "mesh": mesh})
    if missing:
        raise NotImplementedError("; ".join(missing))
    try:
        mesh_axes = parse_mesh_spec(mesh if mesh is not None else (os.environ.get("PATHWAY_MESH") or None))
    except ValueError:
        mesh_axes = None
    G.run_context = {"mesh_axes": mesh_axes}
    run_mesh = resolve_mesh(mesh)
    if run_mesh is None:
        return _run_graph(terminate_on_error)
    with use_mesh(run_mesh):
        return _run_graph(terminate_on_error)


def _run_graph(terminate_on_error: bool) -> RunResult:
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
    runner.run()
    return RunResult()


def run_all(**kwargs: Any) -> RunResult:
    return run(**kwargs)
