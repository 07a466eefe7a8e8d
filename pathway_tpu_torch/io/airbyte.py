"""pw.io.airbyte: stream records from Airbyte source connectors.

The port's copy of the reference's ``io/airbyte.py`` (upstream Pathway's
python/pathway/io/airbyte: read :107, full-refresh/incremental logic in
io/airbyte/logic.py, + third_party/airbyte_serverless). The connector
process speaks the Airbyte protocol on stdout (JSON lines: RECORD / STATE
/ LOG); this reader launches it per sync, forwards RECORD payloads into
the engine, and persists the latest STATE blob through the
connector-offset channel so incremental syncs resume across restarts.

Execution (the serverless runtime, reference
third_party/airbyte_serverless/sources.py): a connector resolves to
- an explicit ``executable=[...]`` argv or Python ``source=`` callable,
- ``docker run --rm -i --volume <tmp>:<tmp> <image>`` when the config
  names a ``docker_image`` and docker is available
  (DockerAirbyteSource :88), or
- a per-connector virtualenv with ``airbyte-<name>`` pip-installed
  once and cached (VenvAirbyteSource :137) when
  ``enforce_method="pypi"`` or docker is absent.

A streaming read ends with its run (or after one sync under
``PATHWAY_TPU_FS_ONESHOT``). ``yaml`` is imported only to read a
``config_file_path``.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Any, Callable, Iterable, Sequence

from ..internals import dtype as dt
from ..internals.schema import ColumnDefinition, schema_builder
from ..internals.table import Table
from ._connector import StreamingContext, input_table_from_reader


def _docker_argv(image: str, mount_dir: str, env_vars: dict | None = None) -> list[str]:
    """``docker run`` argv for a connector image; the sync tempdir is
    volume-mounted at the same path so --config/--state resolve inside
    the container (reference DockerAirbyteSource sources.py:88-111)."""
    argv = ["docker", "run", "--rm", "-i", "--volume", f"{mount_dir}:{mount_dir}"]
    for k, v in (env_vars or {}).items():
        argv += ["-e", f"{k}={v}"]
    return argv + [image]


def _venv_executable(
    connector_name: str, cache_dir: str | None = None, tag: str = ""
) -> list[str]:
    """Install ``airbyte-<connector>`` into a cached per-connector venv
    and return its console-script path (reference VenvAirbyteSource
    sources.py:137-170 — same pip contract, but the venv is cached
    under ~/.cache instead of rebuilt per run)."""
    import subprocess as sp
    import venv as _venv

    root = cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "pathway_tpu", "airbyte_venvs"
    )
    # cache keyed by (name, docker tag): a version bump in the config
    # reinstalls instead of silently reusing the first-ever install
    # (PyPI versions don't map to docker tags — reference sources.py:26
    # — so the install itself stays unpinned, but never goes stale
    # against a changed config)
    vdir = os.path.join(root, f"{connector_name}@{tag or 'latest'}")
    exe = os.path.join(vdir, "bin", connector_name)
    py = os.path.join(vdir, "bin", "python")
    # invoke through the venv's interpreter: console-script shebangs
    # point at the BUILD directory (we install into a tmp dir and
    # rename into place), so direct execution would hit a dead path
    if os.path.exists(exe):
        return [py, exe]
    os.makedirs(root, exist_ok=True)
    # install into a private tmp dir, rename into place when COMPLETE:
    # concurrent processes (pathway spawn) must never observe a
    # half-installed venv (same discipline as ObjectCache.put)
    import tempfile

    tmp = tempfile.mkdtemp(dir=root, prefix=f".{connector_name}.")
    try:
        _venv.create(tmp, with_pip=True)
        pip = os.path.join(tmp, "bin", "pip")
        # pin to the tag when it parses as a PyPI version: a config
        # pinned to an older tag must not silently run the newest
        # release (docker-style tags like 'dev' don't map to versions,
        # so those stay unpinned). NOTE: this path installs from PyPI
        # over the network at reader start — air-gapped deployments
        # should use docker_image or a pre-built venv instead.
        import re

        requirement = f"airbyte-{connector_name}"
        if re.fullmatch(r"\d+(\.\d+)*([a-zA-Z0-9.+-]*)", tag or ""):
            requirement += f"=={tag}"
        proc = sp.run(
            [pip, "install", requirement],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0 and requirement.endswith(f"=={tag}"):
            # docker tags don't always exist on PyPI — fall back to
            # unpinned rather than failing a previously-working config
            proc = sp.run(
                [pip, "install", f"airbyte-{connector_name}"],
                capture_output=True,
                text=True,
            )
        tmp_exe = os.path.join(tmp, "bin", connector_name)
        if proc.returncode != 0 or not os.path.exists(tmp_exe):
            raise RuntimeError(
                f"installing airbyte-{connector_name} into a venv failed "
                f"(rc={proc.returncode}): {proc.stderr[-1000:]}"
            )
        try:
            os.rename(tmp, vdir)
        except OSError:
            pass  # another process won the race with a complete venv
    finally:
        if os.path.isdir(tmp) and tmp != vdir:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    if not os.path.exists(exe):
        raise RuntimeError(f"venv install for {connector_name} left no {exe}")
    return [py, exe]


def _resolve_source_spec(
    config: dict, enforce_method: str | None, env_vars: dict | None
):
    """Reference-style config: {source: {docker_image: ..., config:
    {...}}} -> (argv_factory, connector_config). Python-implemented
    connectors run from a pip venv; anything else through docker."""
    import shutil

    spec = config.get("source", config)
    image = spec.get("docker_image")
    if image is None:
        return None, None
    connector_config = spec.get("config") or {}
    name, _, tag = image.removeprefix("airbyte/").partition(":")
    if enforce_method == "pypi" or (
        enforce_method != "docker" and shutil.which("docker") is None
    ):
        argv = _venv_executable(name, tag=tag)
        return (lambda td: list(argv)), connector_config
    return (lambda td: _docker_argv(image, td, env_vars)), connector_config


def _messages_from_executable(argv, config: dict, state: Any):
    """Run one sync of an Airbyte connector subprocess, yielding parsed
    protocol messages. ``argv`` is a list or a callable(tempdir) ->
    list (docker needs the tempdir mounted)."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        cmd_prefix = list(argv(td) if callable(argv) else argv)
        cfg_path = os.path.join(td, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(config, f)
        cmd = cmd_prefix + ["read", "--config", cfg_path]
        if state is not None:
            state_path = os.path.join(td, "state.json")
            with open(state_path, "w") as f:
                json.dump(state, f)
            cmd += ["--state", state_path]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        completed = False
        try:
            assert proc.stdout is not None
            for line in proc.stdout:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue  # non-protocol logging on stdout
            completed = True
        finally:
            if not completed:
                # early generator exit: don't block on a live connector
                proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        if completed and proc.returncode not in (0, None):
            err = proc.stderr.read() if proc.stderr else ""
            raise RuntimeError(
                f"airbyte connector {cmd_prefix[0]!r} exited with code "
                f"{proc.returncode}: {err[-2000:]}"
            )


def read(
    config_file_path: str | None = None,
    streams: Sequence[str] = (),
    *,
    config: dict | None = None,
    source: Callable[[dict, Any], Iterable[dict]] | None = None,
    executable: list[str] | None = None,
    mode: str = "streaming",
    refresh_interval_ms: int = 60000,
    persistent_id: str | None = None,
    **kwargs: Any,
) -> Table:
    """Read Airbyte streams into a table with columns (stream: str,
    data: Json). ``mode="static"`` runs one sync; streaming re-syncs
    every ``refresh_interval_ms``, passing the connector its last
    emitted STATE (incremental sync) — persisted via connector offsets
    when ``persistent_id`` is set."""
    if config is None:
        if config_file_path is None:
            raise ValueError("airbyte.read: pass config= or config_file_path=")
        import yaml

        with open(config_file_path) as f:
            config = yaml.safe_load(f)
    if source is None and executable is None:
        # serverless runtime: resolve docker_image -> docker run argv,
        # or a cached pip venv for Python-implemented connectors
        executable, connector_config = _resolve_source_spec(
            config, kwargs.pop("enforce_method", None), kwargs.pop("env_vars", None)
        )
        if executable is None:
            raise ValueError(
                "airbyte.read: provide executable=[...] argv, "
                "source=callable, or a config with source.docker_image "
                "(resolved via docker or a pip venv)"
            )
        config = connector_config
    wanted = set(streams) if streams else None

    schema = schema_builder(
        {
            "stream": ColumnDefinition(dtype=dt.STR),
            "data": ColumnDefinition(dtype=dt.JSON),
        },
        name="AirbyteSchema",
    )

    def run_sync(ctx: StreamingContext, state: Any):
        if source is not None:
            messages = source(config, state)
        else:
            messages = _messages_from_executable(executable, config, state)
        new_state = state
        n = 0
        from ..engine.value import Json

        for msg in messages:
            mtype = msg.get("type")
            if mtype == "RECORD":
                rec = msg.get("record", {})
                stream = rec.get("stream", "")
                if wanted is not None and stream not in wanted:
                    continue
                # state rides the offset channel atomically with its rows
                ctx.insert(
                    {"stream": stream, "data": Json(rec.get("data"))},
                    offsets={"__airbyte_state__": new_state} if new_state is not None else None,
                )
                n += 1
            elif mtype == "STATE":
                new_state = msg.get("state")
                ctx.set_offset("__airbyte_state__", new_state)
        # commit when rows OR the cursor moved: an advanced STATE with
        # all records filtered out must still persist (offsets snapshot
        # only at commit)
        if n or new_state != state:
            ctx.commit()
        return new_state

    def reader(ctx: StreamingContext) -> None:
        state = ctx.offsets.get("__airbyte_state__")
        while True:
            state = run_sync(ctx, state)
            if (
                mode == "static"
                or os.environ.get("PATHWAY_TPU_FS_ONESHOT")
                or ctx.wait_stopped(refresh_interval_ms / 1000.0)
            ):
                break

    return input_table_from_reader(
        schema,
        reader,
        name="airbyte",
        persistent_id=persistent_id,
        supports_offsets=True,
    )
