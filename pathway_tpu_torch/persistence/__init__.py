"""pw.persistence: checkpoint/recovery configuration.

The port's copy of the reference package's ``persistence/__init__.py``, a
rebuild of upstream Pathway's python/pathway/persistence/__init__.py
(Backend.filesystem/s3/mock :27-71, Config.simple_config :107). Engine
side: ``engine/persistence.py`` (input snapshots — upstream
src/persistence/input_snapshot.rs)."""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any


class Backend:
    """Storage backend for persistence snapshots."""

    def __init__(
        self,
        kind: str,
        path: str | None = None,
        events: list | None = None,
        bucket_settings: Any = None,
        client: Any = None,
    ):
        self.kind = kind
        self.path = path
        # keep the caller's (initially empty) store object: mock-backend
        # recovery works by handing the SAME store to a fresh Backend
        self.events = events if events is not None else []
        self.bucket_settings = bucket_settings
        # injectable boto3-shaped client (tests use an in-memory fake)
        self.client = client

    @classmethod
    def filesystem(cls, path: str) -> "Backend":
        return cls("filesystem", path=path)

    @classmethod
    def s3(
        cls, root_path: str, bucket_settings: Any = None, *, _client: Any = None
    ) -> "Backend":
        """S3-backed persistence (reference backends/s3.rs:34).
        ``root_path`` is 's3://bucket/prefix' or a bare prefix with the
        bucket taken from ``bucket_settings`` (pw.io.s3.AwsS3Settings)."""
        return cls("s3", path=root_path, bucket_settings=bucket_settings, client=_client)

    @classmethod
    def azure(cls, root_path: str, account: Any = None, **kw) -> "Backend":
        return cls("azure", path=root_path)

    @classmethod
    def mock(cls, events: list | None = None) -> "Backend":
        return cls("mock", events=events)


@dataclass
class Config:
    backend: Backend | None = None
    snapshot_interval_ms: int = 0
    persistence_mode: str = "batch"
    snapshot_access: str = "full"
    continue_after_replay: bool = True
    # record/replay every source, auto-assigning persistent ids by
    # construction order (set by the CLI --record/--replay-mode path)
    auto_persistent_ids: bool = False
    # trim input logs below each operator snapshot so they stay bounded
    # on long-running jobs. Trade-off: after a trim, recovery into a
    # CHANGED program can no longer fall back to full replay (it fails
    # loudly instead) — hence opt-in.
    compact_inputs_on_snapshot: bool = False

    @classmethod
    def simple_config(
        cls,
        backend: Backend,
        *,
        snapshot_interval_ms: int = 0,
        persistence_mode: str = "batch",
        compact_inputs_on_snapshot: bool = False,
        **kwargs,
    ) -> "Config":
        return cls(
            backend=backend,
            snapshot_interval_ms=snapshot_interval_ms,
            persistence_mode=persistence_mode,
            compact_inputs_on_snapshot=compact_inputs_on_snapshot,
        )

    def __post_init__(self):
        pass


# Reference-parity names
PersistenceMode = type("PersistenceMode", (), {"BATCH": "batch", "SPEEDRUN_REPLAY": "speedrun", "PERSISTING": "persisting"})
SnapshotAccess = type("SnapshotAccess", (), {"FULL": "full", "RECORD": "record", "REPLAY": "replay"})

__all__ = [
    "Backend",
    "Config",
    "PersistenceMode",
    "SnapshotAccess",
    "get_persistence_engine_config",
]


@contextmanager
def get_persistence_engine_config(persistence_config: "Config | None"):
    """Context manager bracketing a run with the persistence config's
    before/after hooks and yielding the engine-facing config (reference
    persistence/__init__.py:165). The engine here consumes the Config
    object directly; None passes through for unpersisted runs."""
    if persistence_config is None:
        yield None
        return
    before = getattr(persistence_config, "on_before_run", None)
    if before is not None:
        before()
    try:
        yield persistence_config
    finally:
        after = getattr(persistence_config, "on_after_run", None)
        if after is not None:
            after()
