"""Device mesh for the port: a ``[data, model]`` grid of ``torch.device``s.

Port of ``pathway_tpu/parallel/sharding.py``. The reference builds a
``jax.sharding.Mesh`` whose ``data`` axis plays the role of key-sharded
workers and whose ``model`` axis shards weights tensor-parallel. The port
keeps the grid and its axis names, without JAX: a :class:`DeviceMesh`
holds the devices, ``mesh.shape`` reads ``{"data": n, "model": m}`` as the
reference's ``mesh.shape`` does, and shard ``s`` of the data axis lives on
``devices[s][0]``. The index and the encoder use the data axis only (the
reference replicates them over ``model``, which changes no answer); the
contrastive trainer (``models/training.py``) is the one place that shards
over ``model``, as the reference's does.

Where the reference hands GSPMD a ``NamedSharding``, the port has a
:class:`Placement`: the mesh and, per dimension, the mesh axis it is split
over or None. ``LOGICAL_RULES`` (the reference's tuple) maps the encoder's
logical axes to mesh axes; ``param_sharding`` turns a state dict's logical
axes (``models/encoder.param_logical_axes``) into placements,
``data_sharding`` splits a batch over the ``data`` axis, ``replicated``
places a copy on every device. Nothing moves until a caller splits a
tensor with :meth:`Placement.split` and puts each piece on its device.

``make_mesh()`` takes ``cuda:0 .. cuda:n-1`` and raises when fewer cards
are visible; the CPU only when the caller passes CPU devices
(``devices=["cpu"] * 8``, as the tests do). An explicit device list may
name one device more than once: that is how the CPU tests stand in for
the reference's eight virtual devices, and how one card holds several
shards.

``shard_map(f, mesh=, in_specs=, out_specs=)`` is the counterpart of
``jax.shard_map`` over one mesh axis: eager PyTorch has no SPMD program,
so the body runs once per shard, each on a thread of its own, in lockstep
at its collectives (``ShardAxis.psum`` / ``ppermute`` / ``axis_index``).
``models/long_context.py``'s ring attention is written against it.

``host_mesh_from_env()`` joins the processes of a ``PATHWAY_PROCESSES``
cluster into one ``torch.distributed`` process group and returns the
global mesh (see its docstring).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Sequence

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

# logical axis -> mesh axis (see models/encoder.py param_logical_axes)
LOGICAL_RULES = (
    ("embed", None),
    ("heads", MODEL_AXIS),
    ("mlp", MODEL_AXIS),
    ("vocab", None),
    ("batch", DATA_AXIS),
)


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


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tensor lives on a mesh: ``spec[i]`` is the mesh axis that
    dimension ``i`` is split over, or None; an empty spec is a copy on every
    device. The counterpart of the reference's ``NamedSharding(mesh,
    PartitionSpec(*spec))``."""

    mesh: DeviceMesh
    spec: tuple = ()

    def _dim(self) -> int | None:
        return next((i for i, axis in enumerate(self.spec) if axis is not None), None)

    def split(self, t: torch.Tensor, groups: int = 1) -> list[torch.Tensor]:
        """``t``'s pieces along its split dimension, one per position on
        that mesh axis, in mesh order; ``[t]`` when no dimension is split.
        ``groups``: the dimension is that many equal blocks, each split
        alike (the fused qkv projection's q | k | v). Raises ValueError
        when the dimension does not divide."""
        dim = self._dim()
        if dim is None:
            return [t]
        n, size = self.mesh.shape[self.spec[dim]], t.shape[dim]
        if size % (groups * n):
            raise ValueError(
                f"dimension {dim} of size {size} does not split into {groups} x {n} pieces over {self.spec[dim]!r}"
            )
        v = t.unflatten(dim, (groups, n, size // (groups * n)))
        return [v.select(dim + 1, j).flatten(dim, dim + 1) for j in range(n)]

    def join(self, pieces: Sequence[torch.Tensor], groups: int = 1) -> torch.Tensor:
        """The tensor :meth:`split` cut into ``pieces`` (all on one device)."""
        dim = self._dim()
        if dim is None or len(pieces) == 1:
            return pieces[0]
        blocks = [p.unflatten(dim, (groups, p.shape[dim] // groups)) for p in pieces]
        return torch.stack(blocks, dim=dim + 1).flatten(dim, dim + 2)


def param_sharding(mesh: DeviceMesh, logical_axes: dict) -> dict[str, Placement]:
    """State-dict name -> logical axes (one name or None per dimension, as
    ``models/encoder.param_logical_axes`` gives them) -> name -> the
    :class:`Placement` ``LOGICAL_RULES`` maps them to."""
    rules = dict(LOGICAL_RULES)
    return {
        name: Placement(mesh, tuple(rules.get(axis) if axis is not None else None for axis in axes))
        for name, axes in logical_axes.items()
    }


def data_sharding(mesh: DeviceMesh, ndim: int = 2) -> Placement:
    """Batch-dim placement for activations and inputs."""
    return Placement(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def replicated(mesh: DeviceMesh) -> Placement:
    return Placement(mesh, ())


def axis_devices(mesh: DeviceMesh, axis: str) -> list[torch.device]:
    """The devices along ``axis`` of ``mesh``, in mesh order: the data
    shards' first devices, or the model positions of the first data row."""
    if axis == DATA_AXIS:
        return mesh.data_devices()
    if axis == MODEL_AXIS:
        return list(mesh.devices[0])
    raise ValueError(f"unknown mesh axis {axis!r} (expected {DATA_AXIS!r} or {MODEL_AXIS!r})")


class _Lockstep:
    """The rendezvous of one ``shard_map`` call: every shard hands in its
    value and all of them read every shard's."""

    def __init__(self, n: int):
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n)

    def exchange(self, index: int, value) -> list:
        self.slots[index] = value
        self.barrier.wait()
        values = list(self.slots)
        # nobody writes the next round's slot before everyone has read this one
        self.barrier.wait()
        return values


def _on(value, device: torch.device):
    """``value`` (a tensor, or a tuple or list of them) on ``device``."""
    if isinstance(value, (tuple, list)):
        return type(value)(_on(v, device) for v in value)
    return value.to(device)


class ShardAxis:
    """One shard's view of the mapped mesh axis inside a :func:`shard_map`
    body: the counterparts of ``jax.lax.axis_index``, ``psum`` and
    ``ppermute``. A collective returns once every shard has reached it."""

    def __init__(self, index: int, devices: Sequence[torch.device], group: _Lockstep | None):
        self.index = index
        self.size = len(devices)
        self.device = devices[index]
        self._group = group

    def axis_index(self) -> int:
        return self.index

    def _exchange(self, value) -> list:
        return [value] if self._group is None else self._group.exchange(self.index, value)

    def psum(self, value):
        """The sum over the shards of ``value`` (a tensor, or a tuple or list
        of them), on this shard's device. Every shard adds in shard order, so
        all of them hold the same numbers."""
        values = [_on(v, self.device) for v in self._exchange(value)]
        if isinstance(value, (tuple, list)):
            return type(value)(sum(parts[1:], parts[0]) for parts in zip(*values))
        return sum(values[1:], values[0])

    def ppermute(self, value, shift: int = 1):
        """Rotate ``value`` (a tensor, or a tuple or list of them) ``shift``
        places along the axis: shard ``j``'s value arrives at shard ``(j +
        shift) mod n``. A copy between cards, a no-op on a pooled mesh whose
        shards share one device."""
        values = self._exchange(value)
        return _on(values[(self.index - shift) % self.size], self.device)


def shard_map(f, *, mesh: DeviceMesh, in_specs, out_specs, axis: str = DATA_AXIS):
    """The counterpart of ``jax.shard_map`` over one axis of ``mesh``.

    ``f(ax, *pieces)`` runs once per position of ``axis``, each on its own
    thread and under its own device, in lockstep: its :class:`ShardAxis`
    ``ax`` gives the position and the collectives, which return once every
    shard has reached them. ``in_specs`` holds one entry per argument: a
    spec tuple as :class:`Placement` takes it (the argument is a tensor,
    split along the dimension that names ``axis``, or copied whole for
    ``()``, each piece put on its shard's device), or None (the argument is
    passed to every shard as it is). ``out_specs`` holds one spec per
    output (a single spec when ``f`` returns one tensor): ``()`` takes the
    first shard's output (the body makes it equal on every shard, as
    ``psum`` does), a split spec joins the shards' outputs onto the first
    shard's device. Grad mode is the caller's on every shard. A shard that
    raises stops the others at their next collective, and the call raises
    its error."""
    devices = axis_devices(mesh, axis)
    n = len(devices)
    single_out = not isinstance(out_specs, list) and (not out_specs or not isinstance(out_specs[0], tuple))
    for spec in [*in_specs, *([out_specs] if single_out else out_specs)]:
        if spec is not None and any(isinstance(a, str) and a != axis for a in spec):
            raise ValueError(f"shard_map over {axis!r}: the spec {spec!r} names another mesh axis")

    def place(arg, spec, s: int):
        if spec is None:
            return arg
        pieces = Placement(mesh, tuple(spec)).split(arg)
        return pieces[s if len(pieces) > 1 else 0].to(devices[s])

    def gather(outs: list, spec):
        if not any(a == axis for a in spec):
            return outs[0]
        return Placement(mesh, tuple(spec)).join([o.to(devices[0]) for o in outs])

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} arguments for {len(in_specs)} in_specs")
        group = _Lockstep(n) if n > 1 else None
        grad = torch.is_grad_enabled()
        results: list = [None] * n
        errors: list = [None] * n

        def body(s: int) -> None:
            try:
                ctx = torch.cuda.device(devices[s]) if devices[s].type == "cuda" else contextlib.nullcontext()
                with ctx, torch.set_grad_enabled(grad):
                    pieces = [place(a, spec, s) for a, spec in zip(args, in_specs)]
                    results[s] = f(ShardAxis(s, devices, group), *pieces)
            except BaseException as exc:  # noqa: BLE001 - handed to the caller below
                errors[s] = exc
                if group is not None:
                    group.barrier.abort()

        if n == 1:
            body(0)
        else:
            threads = [threading.Thread(target=body, args=(s,), name=f"shard_map-{axis}-{s}") for s in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        first = next((e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)), None)
        first = first or next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        if single_out:
            return gather(results, tuple(out_specs))
        return tuple(gather([r[i] for r in results], tuple(spec)) for i, spec in enumerate(out_specs))

    return run


def host_mesh_from_env(device: str | None = None) -> DeviceMesh | None:
    """Join the processes of a multi-process run into one mesh; None in a
    single-process run (``PATHWAY_PROCESSES`` unset or 1).

    The environment contract is the reference's (upstream Pathway's
    config.rs:88-120): ``PATHWAY_PROCESSES`` processes, this one
    ``PATHWAY_PROCESS_ID``, the rendezvous at ``PATHWAY_COORDINATOR``
    (``host:port``) or else ``127.0.0.1:PATHWAY_FIRST_PORT``. The process
    joins the default ``torch.distributed`` process group there (``init_method
    tcp://...``), with the ``nccl`` backend on the card and ``gloo`` on the
    CPU (``device="cpu"``; ``None`` is the card when one is visible). NCCL
    wants a card of its own for each process: processes that share one
    card form their group on the CPU.

    The returned mesh is the global ``[data, model]`` grid with one data
    shard per process, in rank order, and ``model`` 1: process ``p``'s shard
    is the card ``cuda:(p mod cards)`` (on one card, every process shares
    ``cuda:0``), or the CPU. A ``DeviceMesh`` holds only devices, so each
    process reaches its own row; the others are its peers in the process
    group, reached through collectives, not through tensors of its own."""
    n_proc = int(os.environ.get("PATHWAY_PROCESSES", "1"))
    if n_proc <= 1:
        return None
    import torch.distributed as dist

    pid = int(os.environ.get("PATHWAY_PROCESS_ID", "0"))
    coord = os.environ.get("PATHWAY_COORDINATOR", f"127.0.0.1:{int(os.environ.get('PATHWAY_FIRST_PORT', '10000'))}")
    on_card = (device is None and torch.cuda.is_available()) or (device is not None and torch.device(device).type == "cuda")
    if on_card:
        cards = torch.cuda.device_count()
        if cards < 1:
            raise ValueError("a mesh on the card needs a visible CUDA card; pass device='cpu' for the CPU")
        devices = [torch.device("cuda", p % cards) for p in range(n_proc)]
        torch.cuda.set_device(devices[pid])
    else:
        devices = [torch.device("cpu")] * n_proc
    if not dist.is_initialized():
        dist.init_process_group(backend="nccl" if on_card else "gloo", init_method=f"tcp://{coord}",
                                world_size=n_proc, rank=pid)
    return DeviceMesh([[d] for d in devices])
