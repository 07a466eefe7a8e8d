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
    "auto"       # the data axis over every visible device; arms the
                 # elastic plane's watermarks (see pathway_tpu_torch/elastic)
    DeviceMesh(...)  # passed through as it is

A spec resolves to ``cuda:0 .. cuda:n-1`` and raises when fewer cards are
visible (one card cannot hold a mesh spec of 4, as in the reference);
``device="cpu"`` resolves it to CPU placements, for the tests. Several
shards on one card take an explicit device list (``sharding.make_mesh(
devices=[...])``).

A *device pool* (:func:`set_device_pool`) stands in for the visible
devices: while one is set, specs on its platform resolve onto its first
devices and ``"auto"`` onto all of it. It is the port's counterpart of the
reference tests' ``--xla_force_host_platform_device_count``: the tests set
eight CPU devices, and ``chip_smoke.py`` several shards on one card. It is
not a user option (no keyword or variable sets it).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Any

import torch

from .sharding import DeviceMesh, make_mesh

__all__ = [
    "parse_mesh_spec",
    "resolve_mesh",
    "active_mesh",
    "set_active_mesh",
    "use_mesh",
]

_lock = threading.Lock()
_active: DeviceMesh | None = None  # run-scoped override
# PATHWAY_MESH resolution is cached on the raw string (and the placement and
# pool it resolved for), so active_mesh() on the add/search path stays a dict
# lookup
_env_cache: dict[tuple, DeviceMesh | None] = {}
_pool: tuple[torch.device, ...] | None = None  # stands in for the visible devices


def set_device_pool(devices) -> tuple[torch.device, ...] | None:
    """Install (``None`` clears) the device list that specs and ``"auto"``
    resolve onto in place of the visible devices; returns the previous
    pool. For tests and ``chip_smoke.py`` only (module docstring)."""
    global _pool
    pool = None if devices is None else tuple(torch.device(d) for d in devices)
    if pool == ():
        raise ValueError("a device pool needs at least one device")
    with _lock:
        prev, _pool = _pool, pool
    return prev


def _pool_for(device) -> tuple[torch.device, ...] | None:
    """The pool when one is set on the platform asked for (any platform
    when ``device`` is None)."""
    with _lock:
        pool = _pool
    if pool is None:
        return None
    if device is not None and torch.device(device).type != pool[0].type:
        return None
    return pool


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
    CPU; otherwise on the first cards, raising when fewer are visible. A
    device pool on the platform asked for takes the place of both, raising
    when it holds fewer devices. ``"auto"``: every visible device (the
    pool, else every card, else one CPU device when ``device="cpu"``) on
    the data axis."""
    if spec is None:
        return None
    if isinstance(spec, DeviceMesh):
        return spec
    axes = parse_mesh_spec(spec)
    if axes is None:
        return None
    pool = _pool_for(device)
    cpu = device is not None and str(device).startswith("cpu")
    if axes.get("auto"):
        # the elastic controller reshards within [min_shards, max_shards]
        # from here
        if pool is not None:
            return make_mesh(devices=pool, model_parallel=1)
        return make_mesh(devices=["cpu"], model_parallel=1) if cpu else make_mesh(model_parallel=1)
    want = axes["data"] * axes["model"]
    if pool is not None:
        if want > len(pool):
            raise ValueError(f"mesh spec {axes} needs {want} devices but the device pool holds {len(pool)}")
        return make_mesh(devices=pool[:want], model_parallel=axes["model"])
    if cpu:
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
    with _lock:
        key = (raw, None if device is None else str(device), _pool)
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
