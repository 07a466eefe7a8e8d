"""Device mesh for the port: a ``[data, model]`` grid of ``torch.device``s.

Port of ``pathway_tpu/parallel/sharding.py``. The reference builds a
``jax.sharding.Mesh`` whose ``data`` axis plays the role of key-sharded
workers and whose ``model`` axis shards weights tensor-parallel. The port
keeps the grid and its axis names, without JAX: a :class:`DeviceMesh`
holds the devices, ``mesh.shape`` reads ``{"data": n, "model": m}`` as the
reference's ``mesh.shape`` does, and shard ``s`` of the data axis lives on
``devices[s][0]``. The index and the encoder use the data axis only (the
reference replicates them over ``model``, which changes no answer); the
``model`` axis is parsed and kept for training, the only place the
reference shards over it (ROADMAP Queue A item 8, with ``param_sharding``
and ``LOGICAL_RULES``).

``make_mesh()`` takes ``cuda:0 .. cuda:n-1`` and raises when fewer cards
are visible; the CPU only when the caller passes CPU devices
(``devices=["cpu"] * 8``, as the tests do). An explicit device list may
name one device more than once: that is how the CPU tests stand in for
the reference's eight virtual devices, and how one card holds several
shards.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
# where the multi-GPU planes not ported yet stand (the elastic reshard,
# mesh="auto", multi-process clusters); their entry points raise naming it
CLUSTER_ITEM = "ROADMAP Queue A item 5 (elastic reshard and multi-process clusters)"


class DeviceMesh:
    """A ``[data, model]`` grid of devices; hashable, compared by its grid."""

    def __init__(self, devices: Sequence[Sequence]):
        grid = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a DeviceMesh needs a non-empty rectangular [data, model] grid of devices")
        self.devices = grid

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    def data_devices(self) -> list[torch.device]:
        """Shard ``s`` of the data axis -> ``devices[s][0]``."""
        return [row[0] for row in self.devices]

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceMesh) and other.devices == self.devices

    def __hash__(self) -> int:
        return hash(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({self.shape}, devices={[str(d) for row in self.devices for d in row]})"


def make_mesh(
    n_devices: int | None = None,
    model_parallel: int | None = None,
    devices: Sequence | None = None,
    heads: int | None = None,
) -> DeviceMesh:
    """Build a (data, model) mesh. ``model_parallel`` must divide the
    device count; the default picks the largest of {4, 2, 1} dividing the
    device count, and ``heads`` too when given, as the reference does.
    ``devices=None``: the first ``n_devices`` cards (all visible ones when
    ``n_devices`` is None), raising when fewer are visible."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if n_devices is None else int(n_devices)
        if want < 1 or want > have:
            raise ValueError(
                f"a mesh of {want} devices needs {want} visible CUDA cards, found {have}; "
                "pass devices=[...] (e.g. devices=['cpu'] * n for the CPU)"
            )
        devices = [torch.device("cuda", i) for i in range(want)]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if model_parallel is None:
        model_parallel = next(tp for tp in (4, 2, 1) if n % tp == 0 and (heads is None or heads % tp == 0))
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n} devices")
    return DeviceMesh([devices[i : i + model_parallel] for i in range(0, n, model_parallel)])


def host_mesh_from_env() -> DeviceMesh | None:
    """Multi-process meshes (``PATHWAY_PROCESSES`` > 1) are not ported;
    one process returns None, as in the reference."""
    if int(os.environ.get("PATHWAY_PROCESSES", "1")) <= 1:
        return None
    raise NotImplementedError(f"a mesh over several processes needs {CLUSTER_ITEM}")
