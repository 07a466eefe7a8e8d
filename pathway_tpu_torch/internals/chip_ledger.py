"""Chip-time attribution ledger: device-seconds per plane account.

The port's copy of the reference's ``internals/chip_ledger.py``. The HBM
ledger (:mod:`pathway_tpu_torch.internals.ledger`) answers "who holds the
bytes"; this module answers "who got the card". A process-wide
:class:`ChipTimeLedger` lets every device dispatch book its measured
device-seconds under a named plane account:

====================  =================================================
account               booked by
====================  =================================================
``encode``            sentence-encoder forward (B1 whole-layer kernels)
``index.search``      KNN top-k (B2; per shard under a mesh)
``index.merge``       KNN cross-shard merge (B2s)
``index.tier``        tiered-index cold fetch (with the tiered index)
``rerank``            device cross-encoder scoring (B3)
``decode``            decode prefill + per-tick step (B5)
``decode.draft``      speculative tick: draft proposal
``decode.verify``     speculative tick: target verification
``ingest.stage``      host->device staging (with the epoch pipeline)
``compile``           ``nvcc`` builds and binds of ``ops/_build.py``
====================  =================================================

**What is booked.** On a CUDA device a booking site passes the device it
dispatched to, and :meth:`ChipTimeLedger.timed` records a pair of
``torch.cuda.Event(enable_timing=True)`` on that device's current stream
around the block, synchronises on the end event and books their elapsed
time. The kernels launch through ctypes on that same stream
(``ops/_build.stream_handle``), so the events bracket them. The block also
opens a ``torch.profiler.record_function`` range named
``chip_ledger::<account>``, so a profiler trace attributes its kernels to
the account (``chip_smoke.py`` holds the bookings against it). Under a mesh
a block names every card it dispatched to and books one figure: the
longest card's elapsed time. On the CPU (and for ``compile``, which is
host work) the block's ``perf_counter`` wall is booked, as the reference
books it. The synchronisation is the reference's opt-in trade: it never
changes a result, it only makes the dispatch wait for the clock.

Speculative decode splits its tick across ``decode.draft`` and
``decode.verify`` (never plain ``decode``), so the draft's cost reads
directly off the ledger.

The residual between booked device-seconds and wall time is the
**stranded** time of the card. :meth:`ChipTimeLedger.snapshot` attributes
it to its causes (host prep, ring stalls, admission-queue wait from the
serving ``queue`` stage histogram, barrier waits); the remainder is
``unattributed``. Per-tenant sub-accounts mirror the DRR scheduler's
chip-seconds bookkeeping.

Accounting is **off by default**. Enable with ``pw.run(chip_ledger=True)``
or ``PATHWAY_CHIP_LEDGER=1``; when off every hook is a no-op and every
surface (``/metrics``, ``/status``) renders nothing, keeping scrapes
byte-identical.

The encode MFU column reads the encoder's kernel statistics
(``internals/profiler.ENCODER_KERNEL_STATS``) against the card's dense
bf16 peak (989 TFLOP/s on an H100); without a card there is none.

Import-light: stdlib only at module level; ``torch`` is looked up only when
a block names a CUDA device.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator

#: Canonical plane accounts (booking is open-vocabulary; these are the
#: ones the built-in dispatch sites use, in render order).
PLANE_ACCOUNTS: tuple[str, ...] = (
    "encode",
    "index.search",
    "index.merge",
    "index.tier",
    "rerank",
    "decode",
    "decode.draft",
    "decode.verify",
    "ingest.stage",
    "compile",
)

#: Stranded-time causes, in attribution order (first claim wins; the
#: remainder is ``unattributed``).
STRANDED_CAUSES: tuple[str, ...] = (
    "host_prep",
    "ring_stall",
    "admission_queue",
    "barrier",
)

_TRUE = {"1", "true", "on", "yes"}

#: Cap on tenants carried in a snapshot (mirrors the tenancy registry's
#: cardinality guard); overflow folds into ``"other"``.
_SNAPSHOT_TENANTS = 50


def chip_ledger_enabled() -> bool:
    """Environment default for chip-time accounting: **off** unless
    ``PATHWAY_CHIP_LEDGER`` opts in (``1``/``true``/``on``/``yes``).
    ``pw.run(chip_ledger=...)`` overrides via :meth:`ChipTimeLedger.set_enabled`."""
    return os.environ.get("PATHWAY_CHIP_LEDGER", "").strip().lower() in _TRUE


#: bf16 dense tensor-core peaks (TFLOP/s) of the cards the port runs on,
#: from NVIDIA's data sheets (SXM parts, without sparsity), by a substring
#: of ``torch.cuda.get_device_name``.
CARD_PEAK_TFLOPS: tuple[tuple[str, float], ...] = (("H100", 989.0),)


def card_peak_tflops(name: str) -> float | None:
    """The bf16 dense peak of the card called ``name``; None when unknown."""
    for key, peak in CARD_PEAK_TFLOPS:
        if key in name:
            return peak
    return None


def chip_peak_tflops() -> float | None:
    """Roofline peak for the encode MFU column: ``PATHWAY_CHIP_PEAK_TFLOPS``
    when set to a positive number, else the bf16 dense peak of card 0
    (989 on an H100). None without a card (or for an unknown card): there
    is then no MFU column."""
    try:
        v = float(os.environ.get("PATHWAY_CHIP_PEAK_TFLOPS", ""))
        if v > 0:
            return v
    except ValueError:
        pass
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return None
    return card_peak_tflops(torch.cuda.get_device_name(0))


def _cuda_devices(device) -> list:
    """The CUDA devices a booking names (a device, a string, or a list of
    them); empty for the CPU or no device."""
    if device is None:
        return []
    items = device if isinstance(device, (list, tuple)) else [device]
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    out = []
    for d in items:
        d = torch.device(d)
        if d.type == "cuda" and d not in out:
            out.append(d)
    return out


class ChipTimeLedger:
    """Thread-safe device-seconds accounting per plane account and
    per tenant, with a stranded-residual model.

    Only :meth:`book` / :meth:`timed` / :meth:`note_stall` run on hot
    paths; each is a guarded dict update under one lock (and a no-op
    when accounting is off). Aggregation happens in :meth:`snapshot`.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # account -> [seconds, dispatches]
        self._accounts: dict[str, list] = {}
        # tenant -> seconds (the DRR per-item mirror)
        self._tenants: dict[str, float] = {}
        # cause -> seconds contributed by explicit stall notes
        self._stalls: dict[str, float] = {}
        self._touched = False
        self._override: bool | None = None
        self._window_t0: float | None = None
        self._window_last: float | None = None
        # per-thread nested-booking counter: ``timed`` subtracts seconds
        # booked *inside* its window (e.g. a jit compile booked by
        # ``wrap_jit`` while the encode site times the same call) so a
        # dispatch's wall is never double-counted across accounts.
        self._tl = threading.local()

    # -- gating --

    def set_enabled(self, on: bool | None) -> None:
        """Runtime override from ``pw.run(chip_ledger=...)``; ``None``
        restores the :func:`chip_ledger_enabled` environment default."""
        self._override = None if on is None else bool(on)

    def on(self) -> bool:
        """True when booking sites should measure (and sync) dispatches."""
        ov = self._override
        return chip_ledger_enabled() if ov is None else ov

    def active(self) -> bool:
        """Anything to render? False until the first booking, keeping
        ``/metrics`` and ``/status`` byte-identical for runs that never
        account chip time."""
        return self._touched

    # -- hot path --

    def book(
        self,
        account: str,
        seconds: float,
        *,
        tenant: str | None = None,
        dispatches: int = 1,
        t0: float | None = None,
    ) -> None:
        """Book ``seconds`` of device time under ``account`` (and
        optionally mirror them into ``tenant``'s sub-account). ``t0``
        is the perf-counter start of the measured span when the caller
        knows it (:meth:`timed` does) — it anchors the booking window
        so wall never under-spans busy."""
        if not self.on():
            return
        seconds = max(0.0, float(seconds))
        now = time.perf_counter()
        start = now - seconds if t0 is None else float(t0)
        with self._lock:
            self._touched = True
            if self._window_t0 is None or start < self._window_t0:
                self._window_t0 = start
            self._window_last = now
            row = self._accounts.get(account)
            if row is None:
                row = self._accounts[account] = [0.0, 0]
            row[0] += seconds
            row[1] += int(dispatches)
            if tenant is not None:
                self._tenants[tenant] = self._tenants.get(tenant, 0.0) + seconds
        tl = self._tl
        tl.nested = getattr(tl, "nested", 0.0) + seconds

    def book_tenant(self, tenant: str, seconds: float) -> None:
        """Tenant-dimension-only booking (the plane work was already
        booked at its own dispatch site; the batcher mirrors the DRR
        per-item chip-seconds split here)."""
        if not self.on():
            return
        with self._lock:
            self._touched = True
            self._tenants[tenant] = self._tenants.get(tenant, 0.0) + max(
                0.0, float(seconds)
            )

    @contextmanager
    def timed(self, account: str, *, tenant: str | None = None, device: Any = None) -> Iterator[None]:
        """Book the enclosed block's device time, minus any seconds booked
        to other accounts from inside it (nested-dispatch dedup).

        ``device``: the CUDA device (or the list of a mesh's cards) the
        block dispatches to. Each gets a pair of timing events on its
        current stream; the end events are synchronised and the longest
        card's elapsed time is booked, once. Without a CUDA device the
        block's ``perf_counter`` wall is booked."""
        if not self.on():
            yield
            return
        tl = self._tl
        n0 = getattr(tl, "nested", 0.0)
        cards = _cuda_devices(device)
        pairs = []
        annotation = None
        if cards:
            import torch

            # a profiler, when one records, attributes the block's kernels
            # to this range (a no-op without a profiler)
            annotation = torch.profiler.record_function(f"chip_ledger::{account}")
            annotation.__enter__()
            for d in cards:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(d))
                pairs.append((d, start, end))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if pairs:
                import torch

                for d, _start, end in pairs:
                    end.record(torch.cuda.current_stream(d))
                annotation.__exit__(None, None, None)
                for _d, _start, end in pairs:
                    end.synchronize()
                dt = max(start.elapsed_time(end) for _d, start, end in pairs) / 1000.0
            else:
                dt = time.perf_counter() - t0
            inner = getattr(tl, "nested", 0.0) - n0
            self.book(account, max(0.0, dt - inner), tenant=tenant, t0=t0)

    def note_stall(self, cause: str, seconds: float) -> None:
        """Accumulate wall seconds a known cause kept the card idle
        (``host_prep``, ``barrier``). Admission-queue wait is read live
        from the serving metrics at snapshot time."""
        if not self.on():
            return
        with self._lock:
            self._touched = True
            self._stalls[cause] = self._stalls.get(cause, 0.0) + max(
                0.0, float(seconds)
            )

    # -- aggregation --

    def wall_seconds(self) -> float:
        """Wall span of the booking window (first booking → now)."""
        with self._lock:
            t0 = self._window_t0
        return 0.0 if t0 is None else max(0.0, time.perf_counter() - t0)

    def _live_stalls(self) -> dict[str, float]:
        """Merge explicit stall notes with the registries that already
        measure their own stall walls (the staging rings, the serving
        queue). Defensive: accounting must never take a run down with it."""
        stalls: dict[str, float]
        with self._lock:
            stalls = dict(self._stalls)
        from ..engine.device_ring import active_rings

        ring = sum(r.stage_stall_s for r in active_rings())
        if ring > 0:
            stalls["ring_stall"] = stalls.get("ring_stall", 0.0) + ring
        try:
            from ..serving.metrics import SERVING_METRICS

            if SERVING_METRICS.active():
                q = SERVING_METRICS.stages.get("queue")
                if q is not None and q.total > 0:
                    stalls["admission_queue"] = (
                        stalls.get("admission_queue", 0.0) + q.total
                    )
        except Exception:
            pass
        return stalls

    def _mfu(self) -> dict[str, Any] | None:
        """Encode-plane MFU against the card's peak, from the encoder's
        kernel statistics (dispatch-clock achieved TFLOP/s over a window);
        None before a dispatch and without a card."""
        from .profiler import ENCODER_KERNEL_STATS

        peak = chip_peak_tflops()
        if not ENCODER_KERNEL_STATS.dispatches or peak is None:
            return None
        enc = ENCODER_KERNEL_STATS.snapshot()
        achieved = float(enc.get("achieved_tflops", 0.0))
        return {
            "achieved_tflops": round(achieved, 3),
            "peak_tflops": round(peak, 3),
            "mfu": round(achieved / peak, 6) if peak > 0 else 0.0,
            "pad_fraction": enc.get("pad_fraction", 0.0),
        }

    def _tenant_block(self, tenants: dict[str, float]) -> dict[str, dict]:
        """Per-tenant chip-time share reconciled against DRR weights."""
        if not tenants:
            return {}
        ranked = sorted(tenants.items(), key=lambda kv: (-kv[1], kv[0]))
        if len(ranked) > _SNAPSHOT_TENANTS:
            head = ranked[:_SNAPSHOT_TENANTS]
            other = sum(s for _, s in ranked[_SNAPSHOT_TENANTS:])
            ranked = head + [("other", other)]
        total = sum(s for _, s in ranked) or 1.0
        # the configured DRR weights beside each tenant's share
        from ..tenancy.config import active_tenancy

        weights: dict[str, float] = {}
        plane = active_tenancy()
        if plane is not None:
            for t, _ in ranked:
                q = plane.quota_for(t) if t != "other" else None
                if q is not None:
                    weights[t] = float(q.weight)
        wsum = sum(weights.values())
        out: dict[str, dict] = {}
        for t, s in ranked:
            row: dict[str, Any] = {
                "seconds": round(s, 6),
                "share": round(s / total, 4),
            }
            if t in weights and wsum > 0:
                row["weight"] = weights[t]
                row["weight_share"] = round(weights[t] / wsum, 4)
            out[t] = row
        return out

    def snapshot(self, wall_s: float | None = None) -> dict:
        """Aggregate view: per-account seconds/dispatches/share, the
        stranded residual vs ``wall_s`` (default: the booking window)
        attributed to its causes, encode MFU, and the per-tenant
        share-vs-weight reconciliation."""
        now = time.perf_counter()
        with self._lock:
            accounts = {a: (row[0], row[1]) for a, row in self._accounts.items()}
            tenants = dict(self._tenants)
            t0 = self._window_t0
        busy = sum(s for s, _ in accounts.values())
        if wall_s is None:
            wall = max(0.0, now - t0) if t0 is not None else 0.0
        else:
            wall = max(0.0, float(wall_s))
        stranded = max(0.0, wall - busy)
        accounted = min(1.0, busy / wall) if wall > 0 else (1.0 if busy else 0.0)

        def _order(name: str) -> tuple:
            try:
                return (0, PLANE_ACCOUNTS.index(name))
            except ValueError:
                return (1, name)

        acc_block = {}
        for name in sorted(accounts, key=_order):
            s, d = accounts[name]
            acc_block[name] = {
                "seconds": round(s, 6),
                "dispatches": d,
                "share": round(s / busy, 4) if busy > 0 else 0.0,
            }

        causes: dict[str, float] = {}
        remaining = stranded
        live = self._live_stalls()
        for cause in STRANDED_CAUSES:
            got = min(remaining, max(0.0, live.get(cause, 0.0)))
            if got > 0:
                causes[cause] = round(got, 6)
                remaining -= got
        for cause, s in sorted(live.items()):
            if cause in STRANDED_CAUSES or remaining <= 0:
                continue
            got = min(remaining, max(0.0, s))
            if got > 0:
                causes[cause] = round(got, 6)
                remaining -= got
        if remaining > 1e-9:
            causes["unattributed"] = round(remaining, 6)

        out: dict[str, Any] = {
            "accounts": acc_block,
            "busy_seconds": round(busy, 6),
            "wall_seconds": round(wall, 6),
            "accounted_fraction": round(accounted, 4),
            "stranded_seconds": round(stranded, 6),
            "stranded_fraction": round(stranded / wall, 4) if wall > 0 else 0.0,
            "stranded_causes": causes,
        }
        mfu = self._mfu()
        if mfu is not None:
            out["encode_mfu"] = mfu
        tb = self._tenant_block(tenants)
        if tb:
            out["tenants"] = tb
        return out

    def reset(self) -> None:
        with self._lock:
            self._accounts.clear()
            self._tenants.clear()
            self._stalls.clear()
            self._touched = False
            self._window_t0 = None
            self._window_last = None


#: Process-wide singleton every dispatch site books into.
CHIP_LEDGER = ChipTimeLedger()
