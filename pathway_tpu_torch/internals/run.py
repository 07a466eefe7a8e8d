"""pw.run / pw.run_all.

The port's copy of the reference's ``internals/run.py``: build the sinks
and subscriptions of the global parse graph ``G`` and run the engine to
completion, on ``PATHWAY_THREADS`` engine workers in each of
``PATHWAY_PROCESSES`` processes. The topology and the cluster's settings
come from ``internals/config.py`` (:func:`get_pathway_config`).

With ``PATHWAY_PROCESSES`` above 1 (``python -m pathway_tpu_torch spawn
--processes P``), every process runs the same program: process 0
(``PATHWAY_PROCESS_ID``) is the coordinator, which owns the sources, the
sinks and persistence, and the others are workers whose sink callbacks are
suppressed (``parallel/multiprocess.py``). ``cluster_accept_timeout=`` /
``cluster_hello_timeout=`` bound cluster formation, ``cluster_lease_ms=``
(default 30 s, 0 off) detects a dead, hung or partitioned worker, and with
persistence a lost worker becomes a partial restart: the coordinator bumps
the durable cluster generation, the survivors regroup at the last snapshot
barrier and, under ``PATHWAY_CLUSTER_RESPAWN`` (default on), only the dead
worker is respawned, up to ``cluster_partial_restarts=`` times (default
3). Each keyword has its ``PATHWAY_CLUSTER_*`` variable. Respawned workers
are reaped when the run ends.

``analysis=`` (or ``PATHWAY_ANALYSIS``): the pre-run verifier gate
(``analysis/``), run over the parse graph after ``G.run_context`` is
recorded and before any sink or reader exists: ``"strict"`` raises
``AnalysisError`` on error-severity findings, ``"warn"`` prints the
findings and runs, ``"deep"`` is ``"strict"`` with the op-level deep pass
(PWL017–PWL020), ``"off"`` (the default) skips it. With
``PATHWAY_ANALYZE_ONLY`` set (``python -m pathway_tpu_torch analyze``)
``pw.run`` records the run context and returns None there: the graph is
described, and no data flows. An unknown keyword raises ``TypeError``;
none is silently ignored.

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

- ``profile=`` (``True``: ``pathway_profile.json``, or a path) /
  ``PATHWAY_PROFILE``: the per-operator run profiler
  (``internals/profiler.py``), its Chrome trace written at the end; the
  profiler also attaches when telemetry or ``with_http_server`` is on;
- ``PATHWAY_JOURNAL_DIR``: the metrics journal's sampler runs for the run
  (``perf/journal.py``);
- ``PATHWAY_TELEMETRY_SERVER``: the OTLP exporter (a file path or an
  http(s) collector; ``internals/telemetry.py``) gets the run span, the
  operators' spans and, with tracing on, the request traces;
  ``PATHWAY_MONITORING_SERVER`` is accepted as the reference accepts it;
- ``license_key=`` (else ``pw.set_license_key``, else
  ``PATHWAY_LICENSE_KEY``): the license tier, whose free tier caps the
  engine workers of the whole cluster (``internals/licensing.py``).

``index_tiers=`` (or ``PATHWAY_INDEX_TIERS``) and ``tenancy=`` (or
``PATHWAY_TENANCY``) are parsed into ``G.run_context["index_tiers"]`` and
``["tenancy"]`` (the configs' knobs, None when off or malformed); an
argument is installed as the run-scoped config for the run only
(``ops.tiered_knn.active_tiers``, ``tenancy.active_tenancy``): the
indexes built while the run lowers its graph become tiered, and the
serving plane and the packed slabs read the tenancy.

``mesh=`` (or ``PATHWAY_MESH``) shards the device-backed indexes over a
mesh's data axis: the spec is parsed into ``G.run_context["mesh_axes"]``
first (None when malformed; the resolve then raises), and a ``mesh=``
argument is resolved and installed as the run-scoped mesh
(``parallel.mesh.active_mesh``) for the run only, so an enclosing
``use_mesh`` survives a run without one. ``PATHWAY_MESH`` is read when an
index is built. ``"auto"`` puts the data axis over every visible device.

``elastic=`` (or ``PATHWAY_ELASTIC``) is parsed into
``G.run_context["elastic"]`` (the config's knobs, None when off or
malformed); an ``elastic=`` argument is installed as the run-scoped
elastic config (``elastic.active_elastic``) for the run only, and
``mesh="auto"`` without one installs ``ElasticConfig(auto=True)``. When
the config has a target shard count or a watermark, the reshard
controller (``elastic.ElasticController``) watches the HBM and chip
ledgers for the run and stops at its end; it reshards the indexes
registered with ``pw.elastic.register_handle``.

``persistence_config=`` checkpoints the run: every source with a
``persistent_id`` logs its committed batches, operator snapshots land
every ``snapshot_interval_ms``, and a run started on the same root
recovers (``engine/persistence.py``). Without it, ``PATHWAY_REPLAY_STORAGE``
(with ``PATHWAY_REPLAY_MODE``: the CLI's ``spawn --record`` /
``--replay-mode``) records or replays every source on a filesystem root.
``recovery=`` (``True``, a restart budget or a ``Recovery``) runs the graph
under the supervisor: each attempt builds a fresh runner (sinks append on
a restart), and a crashed attempt's runner is torn down and its device
memory handed back before the next one builds its own.
``pipeline_depth=`` (or ``PATHWAY_PIPELINE_DEPTH``) above 1 runs the
overlapped epoch pipeline (``engine/pipeline.py``); ``ingest_workers=``
(or ``PATHWAY_INGEST_WORKERS``) sizes the host-ingest stage
(``ingest/stage.py``).

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
from ..elastic.config import ElasticConfig, parse_elastic_spec, use_elastic
from ..ops.tiered_knn import parse_tier_spec, use_tiers
from ..parallel.mesh import parse_mesh_spec, resolve_mesh, use_mesh
from ..tenancy.config import parse_tenancy_spec, use_tenancy
from . import flight_recorder
from .config import get_pathway_config, pathway_config
from .graph_runner import GraphRunner
from .licensing import License, check_worker_count
from .parse_graph import G

logger = logging.getLogger(__name__)

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


def _run_analysis(mode: str | None) -> None:
    """The opt-in pre-run verifier gate, as the reference's: "strict"
    raises AnalysisError on error-severity findings before any sink is
    built or connector started; "warn" prints them to stderr and
    continues; "deep" is "strict" with the op-level pass (PWL017–PWL020);
    "off" (the default) skips. PATHWAY_ANALYSIS supplies the mode when
    the argument is None."""
    if mode is None:
        mode = os.environ.get("PATHWAY_ANALYSIS", "off")
    if mode in ("off", None):
        return
    if mode not in ("strict", "warn", "deep"):
        raise ValueError(
            f"analysis={mode!r}: expected 'strict', 'warn', 'deep', or 'off'"
        )
    from ..analysis import AnalysisError, analyze, has_errors, render_human

    diags = analyze(G, deep=(mode == "deep"))
    if not diags:
        return
    if mode in ("strict", "deep") and has_errors(diags):
        raise AnalysisError(diags)
    print(render_human(diags), file=sys.stderr)


def run(
    *,
    debug: bool = False,
    runtime_typechecking: bool = True,
    terminate_on_error: bool = True,
    persistence_config: Any = None,
    recovery: Any = None,
    pipeline_depth: int | None = None,
    ingest_workers: int | None = None,
    mesh: Any = None,
    decode: Any = None,
    elastic: Any = None,
    monitoring_level: Any = None,
    with_http_server: bool = False,
    monitoring_http_port: int | None = None,
    tracing: Any = None,
    watchdog: Any = None,
    chip_ledger: Any = None,
    freshness: Any = None,
    index_tiers: Any = None,
    tenancy: Any = None,
    profile: Any = None,
    license_key: str | None = None,
    analysis: str | None = None,
    cluster_accept_timeout: float | None = None,
    cluster_hello_timeout: float | None = None,
    cluster_lease_ms: float | None = None,
    cluster_partial_restarts: int | None = None,
    **kwargs: Any,
) -> RunResult | None:
    """Execute all registered outputs/subscriptions to completion (static
    sources) or until all streaming connectors close, on
    ``PATHWAY_THREADS`` engine workers (threads) in each of
    ``PATHWAY_PROCESSES`` processes.

    ``terminate_on_error``: True aborts the run at the first failing
    row; False gives failing rows the ERROR value and an entry in the
    error log. ``debug`` and ``runtime_typechecking`` are accepted as
    the reference accepts them. ``analysis``: the pre-run verifier gate
    (module docstring); the run returns None without running under
    ``PATHWAY_ANALYZE_ONLY``.

    ``persistence_config``, ``recovery``, ``pipeline_depth`` (1: the strict
    loop) and ``ingest_workers`` (0: no stage): persistence, the supervisor,
    the epoch pipeline and the host-ingest stage (module docstring).

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
    this run without a config take.

    ``elastic``: an ``ElasticConfig`` or a spec (``"auto"``, ``4``,
    ``"min=2,max=8,hbm_frac=0.85"``, ...) for the reshard controller of
    this run (module docstring).

    ``index_tiers``: a ``TierConfig`` or a spec (``"hot=4096,clusters=64,
    probe=8"``, a dict, ...) that the device-backed indexes built in this
    run take; ``tenancy``: a ``TenancyConfig`` or a spec (``{"quotas":
    {...}}``, ``"qps=50,inflight=4"``, ...) for the serving plane and the
    packed slabs; ``profile`` and ``license_key``: the profiler and the
    license (module docstring).

    ``cluster_accept_timeout``, ``cluster_hello_timeout``,
    ``cluster_lease_ms`` and ``cluster_partial_restarts``: the
    multi-process cluster's formation limits, lease and partial-restart
    budget (module docstring); None reads the ``PATHWAY_CLUSTER_*``
    variable."""
    if kwargs:
        raise TypeError(f"pw.run() got unexpected keyword arguments {sorted(kwargs)}")
    planes = dict(with_http_server=with_http_server, monitoring_http_port=monitoring_http_port,
                  monitoring_level=monitoring_level, tracing=tracing, watchdog=watchdog, chip_ledger=chip_ledger,
                  freshness=freshness)
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
    elastic_cfg = _parse_or_none(parse_elastic_spec, elastic, "PATHWAY_ELASTIC")
    # the run context records the elastic= / PATHWAY_ELASTIC spec alone, as
    # the reference's does (the verifier reads it; mesh="auto" is its own key)
    elastic_ctx = elastic_cfg.as_dict() if elastic_cfg is not None else None
    run_elastic = elastic_cfg if elastic is not None else None
    if run_elastic is None and elastic_cfg is None and (mesh_axes or {}).get("auto"):
        # mesh="auto" with no elastic= arms the default watermark envelope
        run_elastic = elastic_cfg = ElasticConfig(auto=True)
    tier_cfg = _parse_or_none(parse_tier_spec, index_tiers, "PATHWAY_INDEX_TIERS")
    tenancy_cfg = _parse_or_none(parse_tenancy_spec, tenancy, "PATHWAY_TENANCY")
    resolved = _resolve_planes(**planes, profile=profile)
    pwcfg = get_pathway_config()
    depth = max(1, int(pipeline_depth) if pipeline_depth is not None else pwcfg.pipeline_depth)
    n_ingest = max(0, int(ingest_workers) if ingest_workers is not None else pwcfg.ingest_workers)
    if persistence_config is None and pwcfg.replay_storage:
        persistence_config = _replay_config(pwcfg)
    lease_ms = float(cluster_lease_ms) if cluster_lease_ms is not None else pwcfg.cluster_lease_ms
    G.run_context = {
        "recovery": bool(recovery),
        "persistence": persistence_config is not None,
        "pipeline_depth": depth,
        "ingest_workers": n_ingest,
        "processes": max(1, pwcfg.processes),
        "threads": max(1, pwcfg.threads),
        "cluster_lease_ms": max(0.0, lease_ms),
        "mesh_axes": mesh_axes,
        "index_tiers": tier_cfg.as_dict() if tier_cfg is not None else None,
        "decode": decode_cfg.as_dict() if decode_cfg is not None else None,
        "tenancy": tenancy_cfg.as_dict() if tenancy_cfg is not None else None,
        "elastic": elastic_ctx,
        **resolved["context"],
    }
    if os.environ.get("PATHWAY_ANALYZE_ONLY"):
        # `analyze <program>`: the graph is fully described at this point —
        # return before sinks are built or readers started
        return None
    _run_analysis(analysis)
    # an explicit key, then pw.set_license_key, then PATHWAY_LICENSE_KEY
    lic = License.new(license_key or pathway_config.license_key or pwcfg.license_key)
    check_worker_count(lic, pwcfg.n_workers)  # the free tier's worker cap
    run_mesh = resolve_mesh(mesh)
    if ingest_workers is not None:
        # PATHWAY_INGEST_WORKERS alone is honoured lazily by get_stage()
        from ..ingest import stage as _ingest_stage

        if n_ingest > 0:
            _ingest_stage.configure_stage(n_ingest)
        else:
            _ingest_stage.shutdown_stage()
    durable = {"persistence_config": persistence_config, "recovery": recovery, "pipeline_depth": depth,
               "cluster": _ClusterSpec(
                   threads=max(1, pwcfg.threads), processes=max(1, pwcfg.processes), process_id=pwcfg.process_id,
                   first_port=pwcfg.first_port,
                   accept_timeout=(cluster_accept_timeout if cluster_accept_timeout is not None
                                   else pwcfg.cluster_accept_timeout),
                   hello_timeout=(cluster_hello_timeout if cluster_hello_timeout is not None
                                  else pwcfg.cluster_hello_timeout),
                   lease_ms=lease_ms,
                   partial_budget=(max(0, int(cluster_partial_restarts)) if cluster_partial_restarts is not None
                                   else pwcfg.cluster_partial_restarts),
                   respawn=pwcfg.cluster_respawn)}
    with contextlib.ExitStack() as scope:
        if run_mesh is not None:
            scope.enter_context(use_mesh(run_mesh))
        if index_tiers is not None and tier_cfg is not None:
            scope.enter_context(use_tiers(tier_cfg))
        if decode is not None and decode_cfg is not None:
            scope.enter_context(use_decode(decode_cfg))
        if tenancy is not None and tenancy_cfg is not None:
            scope.enter_context(use_tenancy(tenancy_cfg))
        if run_elastic is not None:
            scope.enter_context(use_elastic(run_elastic))
        if elastic_cfg is not None and (elastic_cfg.watermarks_armed() or elastic_cfg.shards is not None):
            from ..elastic.controller import ElasticController

            controller = ElasticController(elastic_cfg)
            controller.start()
            scope.callback(controller.stop)
        return _run_observed(terminate_on_error, planes, resolved, durable)


def _replay_config(pwcfg):
    """The CLI's record / replay wiring (``spawn --record`` /
    ``--replay-mode`` set ``PATHWAY_REPLAY_STORAGE`` and
    ``PATHWAY_REPLAY_MODE``): a filesystem root that records or replays
    every source, not only those with a ``persistent_id``."""
    from .. import persistence as _persistence

    cfg = _persistence.Config.simple_config(
        _persistence.Backend.filesystem(pwcfg.replay_storage),
        persistence_mode=pwcfg.replay_mode or "batch",
    )
    cfg.auto_persistent_ids = True
    return cfg


@dataclass(frozen=True)
class _ClusterSpec:
    """The run's worker topology and the cluster's fault-domain settings."""

    threads: int = 1
    processes: int = 1
    process_id: int = 0
    first_port: int = 10000
    accept_timeout: float | None = None
    hello_timeout: float | None = None
    lease_ms: float = 30000.0
    partial_budget: int = 3
    respawn: bool = True


def _parse_or_none(parse, spec, env: str):
    """A run option's config, from the argument else its variable; None
    when off or malformed (the reference's run context records None)."""
    try:
        return parse(spec if spec is not None else (os.environ.get(env) or None))
    except ValueError:
        return None


def _resolve_planes(*, with_http_server, monitoring_http_port, monitoring_level, tracing, watchdog, chip_ledger,
                    freshness, profile=None) -> dict:
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
    if profile is True:
        profile_path: str | None = "pathway_profile.json"
    elif profile:
        profile_path = os.fspath(profile)
    else:
        profile_path = os.environ.get("PATHWAY_PROFILE") or None
    return {
        "tracing": tracing_on,
        "watchdog": watchdog_cfg,
        "freshness": freshness_cfg,
        "level": level,
        "profile_path": profile_path,
        "context": {
            "monitoring_level": monitoring_level,
            "with_http_server": bool(with_http_server),
            "tracing": tracing_on,
            "profile": bool(profile) or bool(os.environ.get("PATHWAY_PROFILE")),
            "watchdog": watchdog_cfg is not None,
            "chip_ledger": chip_on,
            "freshness": freshness_cfg.as_dict() if freshness_cfg is not None else None,
            "watchdog_freshness": "freshness_" in str(wd_raw or ""),
        },
    }


def _run_observed(terminate_on_error: bool, planes: dict, resolved: dict, durable: dict) -> RunResult:
    """Install the observability planes for the run, run the graph, and
    restore every plane's previous setting at the end (nested runs in one
    process do not leak them)."""
    from .. import tracing as _tracing
    from ..freshness.plane import FRESHNESS
    from ..io.http._server import _BOUND_PORTS
    from ..perf.journal import JournalSampler, get_journal
    from ..resilience import RecoveryEscalated
    from .chip_ledger import CHIP_LEDGER
    from .monitoring import MonitoringLevel, monitor_stats
    from .profiler import RunProfiler, set_current_profiler
    from .telemetry import Telemetry

    result = RunResult()
    dumps_before = len(flight_recorder.RECORDER._dumped_paths)
    ports_before = len(_BOUND_PORTS)
    prev_tracing = _tracing.set_tracing_enabled(resolved["tracing"])
    prev_chip = CHIP_LEDGER._override
    CHIP_LEDGER.set_enabled(bool(planes["chip_ledger"]) if planes["chip_ledger"] is not None else None)
    prev_fresh = FRESHNESS._override
    FRESHNESS.set_enabled((resolved["freshness"] is not None) if planes["freshness"] is not None else None)
    FRESHNESS.configure(resolved["freshness"])
    telemetry = Telemetry()  # PATHWAY_TELEMETRY_SERVER, else a no-op
    # the profiler: asked for by profile= / PATHWAY_PROFILE, and along
    # whenever a surface that shows its numbers is up (telemetry, /metrics)
    profile_path = resolved["profile_path"]
    profiler = None
    if profile_path is not None or telemetry.enabled or planes["with_http_server"]:
        profiler = RunProfiler()
    journal = get_journal()
    sampler = JournalSampler(journal) if journal is not None else None
    if sampler is not None:
        sampler.start()
    watchdog = None
    if resolved["watchdog"] is not None:
        from .ledger import HealthWatchdog

        watchdog = HealthWatchdog(rules=resolved["watchdog"]["rules"], interval_s=resolved["watchdog"]["interval_s"])
        watchdog.start()
    level = resolved["level"].resolve()
    with_http = bool(planes["with_http_server"])
    need_monitor = with_http or level is not MonitoringLevel.NONE
    mon_ctx = (
        monitor_stats(level, process_id=durable["cluster"].process_id, screen=sys.stderr.isatty())
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
            if profiler is not None:
                set_current_profiler(profiler)  # the wrap_jit and UDF hooks
            try:
                cl = durable["cluster"]
                with telemetry.span("graph_runner.run", workers=cl.threads * cl.processes) as run_span:
                    _run_graph(terminate_on_error, monitor.update if monitor is not None else None, profiler,
                               **durable)
            except RecoveryEscalated:
                raise  # the supervisor already dumped the flight recorder
            except Exception as exc:
                # unsupervised crash: keep the last engine events
                path = flight_recorder.dump("crash", exc)
                if path:
                    logger.error("flight recorder dump written to %s", path)
                raise
            finally:
                if profiler is not None:
                    set_current_profiler(None)
                if monitor is not None:
                    telemetry.gauge("rows_in", monitor.snapshot.rows_in)
                    telemetry.gauge("rows_out", monitor.snapshot.rows_out)
                if profiler is not None and telemetry.enabled:
                    # operator spans nest under the run span and land before
                    # the flush posts /v1/traces
                    profiler.emit_telemetry(telemetry, parent=run_span)
                if resolved["tracing"] and telemetry.enabled:
                    # retained request traces ride the same flush with their
                    # real trace / span ids
                    _tracing.emit_telemetry(telemetry)
                telemetry.flush()
                if profiler is not None and profile_path is not None:
                    profiler.write_chrome_trace(profile_path)
                if http_server is not None:
                    http_server.stop()
    finally:
        if watchdog is not None:
            watchdog.stop()
            # one final evaluation, so a run shorter than the interval still
            # leaves a verdict
            watchdog.evaluate_once()
            result.health = watchdog.verdict()
            health_out = os.environ.get("PATHWAY_HEALTH_OUT")
            if health_out:
                # the doctor command's hand-off (cli.py)
                import json

                try:
                    with open(health_out, "w", encoding="utf-8") as fh:
                        json.dump(result.health, fh, indent=2, sort_keys=True)
                except OSError:
                    logger.warning("could not write health verdict to %s", health_out)
        result.flight_recorder_dumps = list(flight_recorder.RECORDER._dumped_paths[dumps_before:])
        if resolved["tracing"]:
            path = _tracing.TRACE_STORE.dump()
            if path:
                result.trace_dumps.append(path)
        _tracing.set_tracing_enabled(prev_tracing)
        if sampler is not None:
            sampler.stop()  # writes one final sample (the run's parting state)
        CHIP_LEDGER.set_enabled(prev_chip)
        FRESHNESS.set_enabled(prev_fresh)
    result.serving_http_ports = sorted(set(_BOUND_PORTS[ports_before:]))
    return result


def _run_graph(terminate_on_error: bool, monitoring_callback=None, profiler=None, *, persistence_config=None,
               recovery=None, pipeline_depth: int = 1, cluster: _ClusterSpec = _ClusterSpec()) -> None:
    from ..resilience import ClusterRegroup, Recovery, Supervisor

    def build_runner(is_restart: bool) -> GraphRunner:
        """A fresh runner, sinks and subscriptions for each attempt: a
        crashed attempt's engine state is not recoverable in place, the
        persistence layer replays into a clean graph instead."""
        runner = GraphRunner(n_workers=cluster.threads, pipeline_depth=pipeline_depth)
        # sinks read it: fs.write appends instead of truncating on a restart
        runner.recovery_restart = is_restart
        if cluster.processes > 1 and cluster.process_id > 0:
            # a worker process: the same graph, no sink callbacks
            runner.suppress_callbacks = True
        runner.engine.terminate_on_error = terminate_on_error
        for r in runner._replicas:
            r.engine.terminate_on_error = terminate_on_error
        if profiler is not None:
            runner.attach_profiler(profiler)
        if persistence_config is not None:
            for engine in runner._cluster_engines():
                engine.persistence_config = persistence_config
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
        return runner

    # the cluster's fault domain: a partial restart replaces only the dead
    # worker process. The regroup loops run inside one supervisor attempt,
    # so a partial restart never charges the full-restart budget.
    children: list = []
    fence_gens: dict[int, int] = {}

    def respawn_worker(wpid: int, generation: int) -> None:
        """The same interpreter and argv (every process runs the same
        program), with the dead worker's slot and the bumped generation in
        the environment: the generation tells the coordinator the
        replacement from a zombie."""
        import subprocess

        env = dict(os.environ)
        env["PATHWAY_PROCESS_ID"] = str(wpid)
        env["PATHWAY_CLUSTER_GENERATION"] = str(generation)
        children.append(subprocess.Popen([sys.executable] + sys.argv, env=env))

    def run_coordinator(runner: GraphRunner) -> None:
        budget = cluster.partial_budget
        while True:
            try:
                runner.run_coordinator(cluster.processes, cluster.first_port, monitoring_callback=monitoring_callback,
                                       accept_timeout=cluster.accept_timeout, hello_timeout=cluster.hello_timeout,
                                       lease_ms=cluster.lease_ms, fence=fence_gens)
                return
            except ClusterRegroup as regroup:
                path = flight_recorder.dump("cluster.partial_restart", regroup)
                if path:
                    logger.warning("cluster partial restart (generation %d, dead=%s): flight recorder dump written "
                                   "to %s", regroup.generation, regroup.dead_pids, path)
                if budget <= 0:
                    from ..engine.dataflow import EngineError

                    raise EngineError(
                        f"cluster partial-restart budget exhausted ({cluster.partial_budget}): {regroup}"
                    ) from regroup
                budget -= 1
                if cluster.respawn:
                    for wpid in regroup.dead_pids:
                        fence_gens[wpid] = regroup.generation
                        respawn_worker(wpid, regroup.generation)
                # the survivors' volatile state is stale: a fresh runner
                # re-forms the cluster and persistence rehydrates it from the
                # barrier
                runner.release()
                runner = build_runner(True)

    def run_worker(runner: GraphRunner) -> None:
        # a survivor regroups once per partial restart of the coordinator
        # (plus its own lease expiries under a partition); the coordinator
        # keeps the real budget
        budget = cluster.partial_budget + 2
        while True:
            try:
                runner.run_worker(cluster.processes, cluster.first_port, cluster.process_id,
                                  lease_ms=cluster.lease_ms)
                return
            except ClusterRegroup:
                if budget <= 0:
                    raise
                budget -= 1
                runner.release()
                runner = build_runner(True)

    def attempt(is_restart: bool) -> None:
        if is_restart:
            release_crashed_attempt()
        runner = build_runner(is_restart)
        try:
            if cluster.processes <= 1:
                runner.run(monitoring_callback=monitoring_callback)
            elif cluster.process_id == 0:
                run_coordinator(runner)
            else:
                run_worker(runner)
        except BaseException:
            runner.release()
            raise

    try:
        rec = Recovery.coerce(recovery)
        if rec is None:
            attempt(False)
            return
        if persistence_config is None:
            import warnings

            warnings.warn(
                "pw.run(recovery=...) without persistence_config: restarts re-read every source from scratch and "
                "may re-deliver output already flushed before the crash; configure persistence for exactly-once "
                "resumption",
                stacklevel=3,
            )
        Supervisor(rec).run(attempt)
    finally:
        # respawned workers saw END and exit on a clean run; after a failure
        # they must not outlive the coordinator
        for child in children:
            try:
                child.wait(timeout=15.0)
            except Exception:
                child.kill()


def release_crashed_attempt() -> None:
    """Hand a crashed attempt's device memory back before the next attempt
    builds its own. The attempt's runner was torn down as it failed
    (``GraphRunner.release``), so its index slabs, staging rings and
    bookings are garbage once the engine graph's reference cycles are
    collected; the collection drops the HBM ledger's bookings of the
    freed indexes too. The caching allocator's free blocks go back to the
    card as well."""
    import gc

    gc.collect()
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_all(**kwargs: Any) -> RunResult | None:
    return run(**kwargs)
