"""Run-scoped active mesh: how ``pw.run(mesh=...)`` / ``PATHWAY_MESH`` reach
the device-backed indexes without threading a mesh through every stdlib
constructor.

Port of ``pathway_tpu/parallel/mesh.py``, with a :class:`DeviceMesh` in
place of a ``jax.sharding.Mesh``. ``pw.run`` resolves its ``mesh=``
argument to a mesh and installs it here for the run; the index factories
call :func:`active_mesh` when the graph is lowered and pick it up with no
change to the query API. Spec parsing touches no device.

Accepted specs::

    8            # data=8, model=1
    "4x2"        # data=4, model=2
    "data=4,model=2"
    {"data": 4, "model": 2}
    "auto"       # parsed; resolving it raises (it arms the elastic plane,
                 # not ported)
    DeviceMesh(...)  # passed through as it is

A spec resolves to ``cuda:0 .. cuda:n-1`` and raises when fewer cards are
visible (one card cannot hold a mesh spec of 4, as in the reference);
``device="cpu"`` resolves it to CPU placements, for the tests. Several
shards on one card take an explicit device list (``sharding.make_mesh(
devices=[...])``).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Any

from .sharding import CLUSTER_ITEM, DeviceMesh, make_mesh

__all__ = [
    "parse_mesh_spec",
    "resolve_mesh",
    "active_mesh",
    "set_active_mesh",
    "use_mesh",
]

_lock = threading.Lock()
_active: DeviceMesh | None = None  # run-scoped override
# PATHWAY_MESH resolution is cached on the raw string (and the placement it
# resolved for), so active_mesh() on the add/search path stays a dict lookup
_env_cache: dict[tuple[str, str | None], DeviceMesh | None] = {}


def parse_mesh_spec(spec: Any) -> dict[str, int] | None:
    """Normalise a mesh spec to ``{"data": n, "model": m}`` without
    touching a device. None for empty or absent specs; ValueError on
    malformed ones, so a mistyped PATHWAY_MESH fails loudly instead of
    silently running on one device."""
    if spec is None:
        return None
    shape = getattr(spec, "shape", None)
    if shape is not None and hasattr(spec, "devices"):  # a DeviceMesh
        axes = dict(shape)
        return {"data": int(axes.get("data", 1)), "model": int(axes.get("model", 1))}
    if isinstance(spec, bool):
        raise ValueError(f"mesh spec must be int/str/dict/DeviceMesh, got {spec!r}")
    if isinstance(spec, int):
        if spec <= 0:
            raise ValueError(f"mesh device count must be positive, got {spec}")
        return {"data": spec, "model": 1}
    if isinstance(spec, dict):
        data = int(spec.get("data", 1))
        model = int(spec.get("model", 1))
        if data <= 0 or model <= 0:
            raise ValueError(f"mesh axes must be positive, got {spec!r}")
        out = {"data": data, "model": model}
        if spec.get("auto"):
            out["auto"] = True
        return out
    if isinstance(spec, str):
        text = spec.strip()
        if not text:
            return None
        if text.lower() == "auto":
            # the device count resolves when the mesh is built; the parsed
            # shape stays 1x1 and carries the flag
            return {"data": 1, "model": 1, "auto": True}
        if "=" in text:
            axes = {"data": 1, "model": 1}
            for part in text.replace(";", ",").split(","):
                name, _, val = part.partition("=")
                name = name.strip()
                if name not in axes:
                    raise ValueError(f"unknown mesh axis {name!r} in {spec!r} (expected data= and/or model=)")
                axes[name] = int(val)
            return parse_mesh_spec(axes)
        if "x" in text:
            data_s, _, model_s = text.partition("x")
            return parse_mesh_spec({"data": int(data_s), "model": int(model_s)})
        return parse_mesh_spec(int(text))
    raise ValueError(f"mesh spec must be int/str/dict/DeviceMesh, got {spec!r}")


def resolve_mesh(spec: Any, device=None) -> DeviceMesh | None:
    """A :class:`DeviceMesh` for ``spec`` (a DeviceMesh passes through).
    None for empty specs. ``device="cpu"`` places the spec's devices on the
    CPU; otherwise on the first cards, raising when fewer are visible.
    ``"auto"`` raises: it arms the elastic plane."""
    if spec is None:
        return None
    if isinstance(spec, DeviceMesh):
        return spec
    axes = parse_mesh_spec(spec)
    if axes is None:
        return None
    if axes.get("auto"):
        raise NotImplementedError(f"mesh='auto' arms the elastic reshard plane: it needs {CLUSTER_ITEM}")
    want = axes["data"] * axes["model"]
    if device is not None and str(device).startswith("cpu"):
        return make_mesh(devices=["cpu"] * want, model_parallel=axes["model"])
    return make_mesh(n_devices=want, model_parallel=axes["model"])


def set_active_mesh(mesh: DeviceMesh | None) -> None:
    """Install (or clear, with None) the run-scoped active mesh."""
    global _active
    with _lock:
        _active = mesh


def active_mesh(device=None) -> DeviceMesh | None:
    """The mesh the device-backed indexes shard over: the run-scoped mesh
    when one is installed, else ``PATHWAY_MESH`` resolved (on the CPU when
    ``device="cpu"``), else None (one device)."""
    with _lock:
        if _active is not None:
            return _active
    raw = os.environ.get("PATHWAY_MESH", "").strip()
    if not raw:
        return None
    key = (raw, None if device is None else str(device))
    with _lock:
        if key in _env_cache:
            return _env_cache[key]
    mesh = resolve_mesh(raw, device=device)
    with _lock:
        _env_cache[key] = mesh
    return mesh


@contextmanager
def use_mesh(mesh: DeviceMesh | None):
    """Scoped :func:`set_active_mesh`: the previous mesh comes back on exit,
    so nested runs and tests cannot leak a mesh into each other."""
    global _active
    with _lock:
        prev = _active
        _active = mesh
    try:
        yield mesh
    finally:
        with _lock:
            _active = prev
