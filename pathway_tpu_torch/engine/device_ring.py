"""Depth-``n`` staging ring of engine-owned device buffers.

The port's copy of the reference's ``engine/device_ring.py``. A stream of
host payloads (the tiered index's cold candidates) is staged onto the card
through ``depth`` slots. In PyTorch a slot is a pinned host buffer plus a
device buffer per array; staging writes the payload into the pinned buffer
and copies it to the device buffer with ``non_blocking=True`` on a side
stream, so the host is free while the copy runs. The reference donates the
buffer a slot held two generations ago; here the buffers persist and are
*reused*, under two rules:

- a staged handle is **engine-owned**: the consumer reads it for one use
  and then calls :meth:`DeviceRing.retire`, which records an event on the
  consumer's stream;
- a slot is rewritten only after its previous copy finished (the host
  waits for the copy's event before touching the pinned buffer) and after
  the consumer's retire event (the side stream waits for it on the
  device). A slot whose consumer never retired makes the next
  :meth:`stage` into it wait for the whole device (counted in
  ``stage_stall_s``): overwriting it earlier would hand a still-running
  rescore new numbers, which no CPU test can see.

The consumer's stream waits for the copy's event before :meth:`stage`
returns, so the handles are ready for work queued after it. On the CPU a
slot is a plain buffer and a copy is synchronous. :func:`quiesce_all` waits
for every registered ring's copies in flight.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref

import numpy as np
import torch

__all__ = ["DeviceRing", "quiesce_all", "active_rings", "staging_placement"]


def staging_placement(mesh_axes: dict | None) -> dict:
    """Declarative placement intent of staged payloads for the deep
    verifier (analysis.deep, PWL019), resolved without constructing a ring
    or touching a device, as the reference's: with a run mesh the engine
    stages each epoch's rows onto the mesh's data devices (the index routes
    them to their shards); without one they land on the default device,
    and a mesh-sharded consumer takes them through the host."""
    axes = dict(mesh_axes) if mesh_axes else None
    return {
        "kind": "device_ring",
        "mesh_axes": axes,
        "sharded": bool(axes and int(axes.get("data", 1)) > 1),
    }

_ring_seq = itertools.count()

# every live ring, so a snapshot path can quiesce staged transfers it has
# no direct handle to
_registry: "weakref.WeakSet[DeviceRing]" = weakref.WeakSet()
_registry_lock = threading.Lock()


def active_rings() -> list["DeviceRing"]:
    with _registry_lock:
        return list(_registry)


def quiesce_all() -> None:
    """Block until no registered ring has a copy in flight."""
    for ring in active_rings():
        ring.sync()


class _Slot:
    __slots__ = ("host", "dev", "copied", "consumed", "retired", "handles", "nbytes")

    def __init__(self) -> None:
        self.host: list[torch.Tensor] = []  # pinned on a card, one per array
        self.dev: list[torch.Tensor] = []
        self.copied = None  # torch.cuda.Event of the last copy into dev
        self.consumed = None  # torch.cuda.Event recorded by retire()
        self.retired = True
        self.handles: list[torch.Tensor] | None = None
        self.nbytes = 0


class DeviceRing:
    """A ``depth``-slot ring of staged device buffers for one payload
    stream (see the module docstring)."""

    def __init__(self, depth: int = 2, name: str = "ring", device=None):
        from ..device import resolve_device

        self.depth = max(2, int(depth))
        self.name = name
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(device=self.device) if self._cuda else None
        self._slots = [_Slot() for _ in range(self.depth)]
        self._next = 0
        self._lock = threading.Lock()
        # serialises whole stage() calls: two producers must not lap the
        # ring onto a slot the other is still filling
        self._stage_lock = threading.Lock()
        self.staged = 0  # stage() calls
        self.donated = 0  # buffers reused by a later generation
        self.stage_stall_s = 0.0  # time stage() waited on an unretired slot
        self.bytes_staged = 0  # host->device bytes through the ring
        self.high_water = 0  # most generations in flight at once
        self._ledger_owner = f"{name}@{next(_ring_seq)}"
        from ..internals.ledger import LEDGER

        weakref.finalize(self, LEDGER.drop, "ring", self._ledger_owner)
        with _registry_lock:
            _registry.add(self)

    def _buffers(self, slot: _Slot, i: int, src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Slot ``slot``'s i-th host and device buffers, at least as large
        as ``src`` and of its dtype (reallocated when not)."""
        n = src.numel()
        if i < len(slot.host) and slot.host[i].dtype == src.dtype and slot.host[i].numel() >= n:
            return slot.host[i], slot.dev[i]
        host = torch.empty(max(n, 1), dtype=src.dtype, pin_memory=self._cuda)
        dev = torch.empty(max(n, 1), dtype=src.dtype, device=self.device)
        if i < len(slot.host):
            slot.host[i], slot.dev[i] = host, dev
        else:
            slot.host.append(host)
            slot.dev.append(dev)
        return host, dev

    def stage(self, arrays) -> list[torch.Tensor]:
        """Copy ``arrays`` (numpy arrays or CPU tensors) into the next slot
        and return device tensors of their shapes, valid until the slot is
        retired and reused."""
        single = not isinstance(arrays, (list, tuple))
        items = [arrays] if single else list(arrays)
        srcs = [a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a)) for a in items]
        with self._stage_lock:
            with self._lock:
                idx = self._next
                self._next = (idx + 1) % self.depth
                slot = self._slots[idx]
                reused = slot.handles is not None
                retired = slot.retired
            if reused:
                if not retired:
                    # the consumer still holds the previous generation:
                    # wait until the device has run everything queued
                    # (backpressure, not a silent overwrite)
                    t0 = time.perf_counter()
                    if self._cuda:
                        torch.cuda.synchronize(self.device)
                    self.stage_stall_s += time.perf_counter() - t0
                elif slot.copied is not None:
                    # the pinned buffer is the source of the last copy
                    slot.copied.synchronize()
                self.donated += len(slot.handles)
                from ..internals import flight_recorder

                flight_recorder.record("ring.donate", ring=self.name, buffers=len(slot.handles), total=self.donated)
            from ..internals.chip_ledger import CHIP_LEDGER

            c0 = time.perf_counter()
            handles = []
            for i, src in enumerate(srcs):
                host, dev = self._buffers(slot, i, src)
                n = src.numel()
                host[:n].copy_(src.reshape(-1))
                handles.append((dev[:n], host[:n], src.shape))
            if self._cuda:
                consumer = torch.cuda.current_stream(self.device)
                with torch.cuda.stream(self._stream):
                    if slot.consumed is not None:
                        self._stream.wait_event(slot.consumed)
                    for dev, host, _ in handles:
                        dev.copy_(host, non_blocking=True)
                    slot.copied = torch.cuda.Event()
                    slot.copied.record(self._stream)
                consumer.wait_event(slot.copied)
            else:
                for dev, host, _ in handles:
                    dev.copy_(host)
            if CHIP_LEDGER.on():
                # copy-issue wall only: staging stays non-blocking under
                # accounting (the stall above is a stranded-time cause)
                CHIP_LEDGER.book("ingest.stage", time.perf_counter() - c0)
            out = [dev.view(shape) for dev, _, shape in handles]
            nbytes = sum(int(s.numel() * s.element_size()) for s in srcs)
            with self._lock:
                slot.handles = out
                slot.retired = False
                slot.consumed = None
                slot.nbytes = sum(int(d.numel() * d.element_size()) for d in slot.dev)
                self.staged += 1
                self.bytes_staged += nbytes
                self.high_water = max(self.high_water, self._in_flight_locked())
                live = sum(s.nbytes for s in self._slots)
                in_use = sum(s.nbytes for s in self._slots if not s.retired)
            from ..internals.ledger import LEDGER

            LEDGER.update("ring", self._ledger_owner, live, used_bytes=in_use)
            return out

    def _in_flight_locked(self) -> int:
        return sum(1 for s in self._slots if s.handles is not None and not s.retired)

    def retire(self, handles: list[torch.Tensor]) -> None:
        """The consumer has queued its last read of ``handles``: their slot
        may be reused once the device has run that read."""
        with self._lock:
            for slot in self._slots:
                if slot.handles is not None and len(slot.handles) == len(handles) and all(
                    a is b for a, b in zip(slot.handles, handles)
                ):
                    if self._cuda:
                        slot.consumed = torch.cuda.Event()
                        slot.consumed.record(torch.cuda.current_stream(self.device))
                    slot.retired = True

    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight_locked()

    def stats(self) -> dict:
        """Staging telemetry for the host-path attribution."""
        with self._lock:
            return {
                "ring": self.name,
                "depth": self.depth,
                "staged": self.staged,
                "donated": self.donated,
                "bytes_staged": self.bytes_staged,
                "high_water": self.high_water,
                "stage_stall_s": self.stage_stall_s,
            }

    def sync(self) -> None:
        """Block until every staged copy has landed on the device."""
        with self._lock:
            events = [s.copied for s in self._slots if s.copied is not None]
        for ev in events:
            ev.synchronize()

    def snapshot_view(self, handles: list[torch.Tensor]) -> list[np.ndarray]:
        """Host copies of staged handles, never the ring's buffers."""
        self.sync()
        return [h.detach().cpu().numpy().copy() for h in handles]
