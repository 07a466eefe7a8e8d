"""Runtime configuration from the ``PATHWAY_*`` environment variables.

The port's copy of the reference's ``internals/config.py`` (upstream
Pathway's ``internals/config.py`` and the engine's worker topology,
``src/engine/dataflow/config.rs``: ``PATHWAY_THREADS``,
``PATHWAY_PROCESSES``, ``PATHWAY_PROCESS_ID``, ``PATHWAY_FIRST_PORT``).
``pw.run`` reads the run's topology, the cluster's fault-domain settings
and the CLI's record / replay wiring from :func:`get_pathway_config`;
``pw.set_license_key`` and ``pw.set_monitoring_config`` set the
module-level :data:`pathway_config`."""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v else default
    except ValueError:
        return default


@dataclass
class PathwayConfig:
    license_key: str | None = None
    monitoring_server: str | None = None
    ignore_asserts: bool = False
    runtime_typechecking: bool = True
    terminate_on_error: bool = True
    process_id: int = 0

    @property
    def threads(self) -> int:
        return _env_int("PATHWAY_THREADS", 1)

    @property
    def processes(self) -> int:
        return _env_int("PATHWAY_PROCESSES", 1)

    @property
    def n_workers(self) -> int:
        return self.threads * self.processes

    @property
    def replay_storage(self) -> str | None:
        return os.environ.get("PATHWAY_REPLAY_STORAGE")

    @property
    def replay_mode(self) -> str:
        return os.environ.get("PATHWAY_REPLAY_MODE", "")

    @property
    def first_port(self) -> int:
        return _env_int("PATHWAY_FIRST_PORT", 10000)

    @property
    def monitoring_http_port(self) -> int | None:
        """Explicit /metrics port (PATHWAY_MONITORING_HTTP_PORT); None
        falls back to 20000 + process_id. 0 = ephemeral."""
        v = os.environ.get("PATHWAY_MONITORING_HTTP_PORT")
        if not v:
            return None
        try:
            return int(v)
        except ValueError:
            return None

    @property
    def profile_path(self) -> str | None:
        """Chrome-trace output path (PATHWAY_PROFILE); set by the
        ``pathway profile`` CLI subcommand."""
        return os.environ.get("PATHWAY_PROFILE") or None

    @property
    def pipeline_depth(self) -> int:
        """Overlapped epoch pipeline depth (PATHWAY_PIPELINE_DEPTH):
        1 = strict serial epochs (default), >= 2 stages epoch N+1 on
        the host while epoch N executes (engine/pipeline.py)."""
        return max(1, _env_int("PATHWAY_PIPELINE_DEPTH", 1))

    @property
    def ingest_workers(self) -> int:
        """Collaborative host-ingest stage size (PATHWAY_INGEST_WORKERS):
        0 = no stage (default, strict inline prep); N >= 1 runs tokenize
        /pack/resolve prep on N host workers with a single ordered
        committer (``ingest/``)."""
        return max(0, _env_int("PATHWAY_INGEST_WORKERS", 0))

    @property
    def ingest_autoscale(self) -> bool:
        """Queue-depth autoscaling for the ingest stage
        (PATHWAY_INGEST_AUTOSCALE): grow on backlog / host-bound
        attribution up to PATHWAY_INGEST_MAX_WORKERS, shrink on idle."""
        return os.environ.get("PATHWAY_INGEST_AUTOSCALE", "0") not in ("0", "", "false")

    @property
    def ingest_max_workers(self) -> int:
        """Autoscale ceiling (PATHWAY_INGEST_MAX_WORKERS, default 8)."""
        return max(1, _env_int("PATHWAY_INGEST_MAX_WORKERS", 8))

    @property
    def mesh_spec(self) -> str | None:
        """Raw mesh spec string (PATHWAY_MESH, e.g. "8" / "4x2" /
        "data=4,model=2"); parsed by parallel.mesh.parse_mesh_spec and
        resolved lazily — device-backed indexes shard over it when no
        explicit ``pw.run(mesh=...)`` is given."""
        return os.environ.get("PATHWAY_MESH") or None

    @property
    def flight_recorder(self) -> bool:
        """Black-box flight recorder on/off (PATHWAY_FLIGHT_RECORDER;
        default on — recording is an in-memory ring append)."""
        v = os.environ.get("PATHWAY_FLIGHT_RECORDER")
        if v is None or v == "":
            return True
        return v.lower() not in ("0", "false", "off", "no")

    @property
    def flight_recorder_size(self) -> int:
        """Ring capacity in events (PATHWAY_FLIGHT_RECORDER_SIZE)."""
        return max(16, _env_int("PATHWAY_FLIGHT_RECORDER_SIZE", 512))

    @property
    def flight_recorder_dir(self) -> str | None:
        """Crash-dump directory (PATHWAY_FLIGHT_RECORDER_DIR); None =
        the flight recorder's default."""
        return os.environ.get("PATHWAY_FLIGHT_RECORDER_DIR") or None

    @property
    def cluster_accept_timeout(self) -> float | None:
        """Seconds the coordinator waits for all workers to connect
        (PATHWAY_CLUSTER_ACCEPT_TIMEOUT); None = CoordinatorCluster
        default (60 s)."""
        v = os.environ.get("PATHWAY_CLUSTER_ACCEPT_TIMEOUT")
        if not v:
            return None
        try:
            return float(v)
        except ValueError:
            return None

    @property
    def cluster_hello_timeout(self) -> float | None:
        """Seconds allowed for one connected worker's hello handshake
        (PATHWAY_CLUSTER_HELLO_TIMEOUT); None = default (10 s)."""
        v = os.environ.get("PATHWAY_CLUSTER_HELLO_TIMEOUT")
        if not v:
            return None
        try:
            return float(v)
        except ValueError:
            return None

    @property
    def cluster_lease_ms(self) -> float:
        """Worker lease in milliseconds (PATHWAY_CLUSTER_LEASE_MS,
        default 30000): both sides of the cluster channel heartbeat at
        lease/3 and treat a socket silent for a whole lease as a lost
        peer. 0 disables leases (legacy blocking protocol)."""
        v = os.environ.get("PATHWAY_CLUSTER_LEASE_MS")
        if not v:
            return 30000.0
        try:
            return max(0.0, float(v))
        except ValueError:
            return 30000.0

    @property
    def cluster_partial_restarts(self) -> int:
        """Partial-restart budget per run (PATHWAY_CLUSTER_PARTIAL_RESTARTS,
        default 3): how many cluster regroups internals/run.py performs
        before the failure escalates to the full-restart supervisor."""
        return max(0, _env_int("PATHWAY_CLUSTER_PARTIAL_RESTARTS", 3))

    @property
    def cluster_respawn(self) -> bool:
        """Whether the coordinator respawns dead workers itself
        (PATHWAY_CLUSTER_RESPAWN, default on). Off, it only regroups
        with the survivors rejoining — for launchers (or tests) that own
        worker process lifecycles."""
        v = os.environ.get("PATHWAY_CLUSTER_RESPAWN")
        if v is None or v == "":
            return True
        return v.lower() not in ("0", "false", "off", "no")

    @property
    def flight_recorder_keep(self) -> int:
        """Black-box dump retention (PATHWAY_FLIGHT_RECORDER_KEEP):
        keep only the N newest blackbox-*.json files in the dump
        directory after each dump. 0 (default) keeps everything."""
        return max(0, _env_int("PATHWAY_FLIGHT_RECORDER_KEEP", 0))


def get_pathway_config() -> PathwayConfig:
    cfg = PathwayConfig()
    cfg.license_key = os.environ.get("PATHWAY_LICENSE_KEY")
    cfg.monitoring_server = os.environ.get("PATHWAY_MONITORING_SERVER")
    cfg.ignore_asserts = os.environ.get("PATHWAY_IGNORE_ASSERTS", "").lower() in ("1", "true")
    cfg.process_id = _env_int("PATHWAY_PROCESS_ID", 0)
    return cfg


pathway_config = get_pathway_config()


def set_license_key(key: str | None) -> None:
    pathway_config.license_key = key


def set_monitoring_config(*, server_endpoint: str | None) -> None:
    pathway_config.monitoring_server = server_endpoint
