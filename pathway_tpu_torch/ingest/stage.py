"""Collaborative CPU↔device host-ingest stage (WindVE-style).

A bounded work-queue pool of host workers sits between connectors and
the device models: workers run the CPU-heavy prep (native tokenizer
shards that release the GIL, image quantize/YUV-pack), while ONE
committer — the caller of :meth:`HostIngestStage.map_ordered` —
consumes results strictly in submission order and performs the device
staging.  That single-committer discipline is what makes the output
byte-identical at any worker count: parallelism only reorders *work*,
never *commits*, the same guarantee `pipeline_depth` gives the epoch
pipeline.

Fault model: the chaos site ``ingest.worker`` fires *before* a worker
touches its task, so a chaos-killed worker dies without side effects
and the committer transparently re-executes the task inline — a dying
worker degrades throughput but never drops or reorders a row.

Autoscaling: grow when the queue backlog stays above a per-worker
watermark (and `host_prep` dominates `device_wait` when the pipeline
reports attribution), shrink after sustained idle; both transitions are
recorded as ``ingest.autoscale`` flight events.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Sequence

from .metrics import INGEST_METRICS

# Backlog-per-worker watermark above which the autoscaler grows the
# pool, and the number of consecutive idle observations before it
# shrinks.  Cooldown keeps grow/shrink from thrashing on bursty queues.
_GROW_BACKLOG_PER_WORKER = 2
_SHRINK_IDLE_OBSERVATIONS = 8
_AUTOSCALE_COOLDOWN_S = 0.05

_CHAOS_SENTINEL = object()


def placement_intent(workers: int) -> dict:
    """Declarative output-placement intent of the host-ingest pool for
    the deep verifier (analysis.deep, PWL019): pool workers produce
    HOST buffers (numpy id matrices, packed rows) — the single
    committer performs the device staging — so its output is on-mesh
    exactly when the committer's ring staging is."""
    return {
        "kind": "ingest_pool",
        "workers": max(0, int(workers)),
        "host_output": True,
    }


class _Task:
    __slots__ = ("seq", "fn", "args", "kwargs", "value", "error", "chaos", "done")

    def __init__(self, seq: int, fn: Callable, args: tuple, kwargs: dict) -> None:
        self.seq = seq
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.value: Any = None
        self.error: BaseException | None = None
        self.chaos = False
        self.done = threading.Event()

    def run(self) -> None:
        try:
            self.value = self.fn(*self.args, **self.kwargs)
        except BaseException as exc:  # surfaced at commit time
            self.error = exc
        finally:
            self.done.set()


class Ticket:
    """Handle returned by :meth:`HostIngestStage.submit`."""

    def __init__(self, stage: "HostIngestStage", task: _Task) -> None:
        self._stage = stage
        self._task = task

    @property
    def seq(self) -> int:
        return self._task.seq

    def result(self) -> Any:
        return self._stage._commit(self._task)


class HostIngestStage:
    """Bounded multi-worker host prep pool with an ordered committer."""

    def __init__(
        self,
        workers: int = 1,
        *,
        max_queue: int | None = None,
        autoscale: bool = False,
        min_workers: int = 1,
        max_workers: int = 8,
        name: str = "ingest",
    ) -> None:
        workers = max(1, int(workers))
        self.name = name
        self.autoscale = bool(autoscale)
        self.min_workers = max(1, int(min_workers))
        self.max_workers = max(self.min_workers, int(max_workers))
        if self.autoscale:
            workers = min(max(workers, self.min_workers), self.max_workers)
        self._queue: queue.Queue = queue.Queue(
            maxsize=max_queue if max_queue is not None else 4 * self.max_workers
        )
        self._lock = threading.Lock()
        self._seq = 0
        self._target_workers = workers
        self._threads: list[threading.Thread] = []
        self._shutdown = False
        self._idle_obs = 0
        self._last_scale = 0.0
        INGEST_METRICS.set_workers(workers)
        self._ensure_workers()

    # -- introspection --

    @property
    def workers(self) -> int:
        with self._lock:
            return self._target_workers

    def queue_depth(self) -> int:
        return self._queue.qsize()

    # -- submission / commit --

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> Ticket:
        if self._shutdown:
            raise RuntimeError("ingest stage is shut down")
        with self._lock:
            self._seq += 1
            task = _Task(self._seq, fn, args, kwargs)
        self._maybe_autoscale()
        self._ensure_workers()
        self._queue.put(task)
        depth = self._queue.qsize()
        INGEST_METRICS.note_enqueue(depth)
        self._record("ingest.enqueue", seq=task.seq, depth=depth)
        return Ticket(self, task)

    def _commit(self, task: _Task) -> Any:
        while not task.done.wait(timeout=0.1):
            # Chaos can kill every worker between submit and commit;
            # respawn up to the target so queued tasks make progress.
            self._ensure_workers()
        retried = False
        if task.chaos:
            # The worker died before touching the task (chaos fires
            # pre-execution), so an inline re-run is exactly-once.
            retried = True
            task.chaos = False
            task.error = None
            task.run()
        INGEST_METRICS.note_commit(retried=retried)
        if task.error is not None:
            raise task.error
        return task.value

    def map_ordered(
        self, fn: Callable, items: Iterable[Any], *, window: int | None = None
    ) -> Iterator[Any]:
        """Run ``fn`` over ``items`` on the pool, yield results in order.

        The caller is the single committer: results are surfaced
        strictly in submission order regardless of which worker
        finished first, so downstream staging stays byte-identical to
        the inline loop.  ``window`` bounds how far submission runs
        ahead of commits (default: queue capacity).
        """
        if window is None:
            window = max(2, self._queue.maxsize)
        pending: list[Ticket] = []
        for item in items:
            pending.append(self.submit(fn, item))
            if len(pending) >= window:
                yield pending.pop(0).result()
        for ticket in pending:
            yield ticket.result()

    # -- worker pool --

    def _ensure_workers(self) -> None:
        with self._lock:
            if self._shutdown:
                return
            self._threads = [t for t in self._threads if t.is_alive()]
            need = self._target_workers - len(self._threads)
            for _ in range(max(0, need)):
                t = threading.Thread(
                    target=self._worker_loop, name=f"{self.name}-worker", daemon=True
                )
                self._threads.append(t)
                t.start()

    def _worker_loop(self) -> None:
        from ..resilience import chaos as _chaos

        while True:
            try:
                task = self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._shutdown or self._surplus():
                    return
                continue
            if task is _CHAOS_SENTINEL or task is None:
                return
            t0 = time.monotonic()
            try:
                _chaos.inject(f"{self.name}.worker")
            except BaseException:
                # Dying worker: hand the untouched task back to the
                # committer and exit this thread.
                task.chaos = True
                task.done.set()
                INGEST_METRICS.note_dequeue(self._queue.qsize(), 0.0)
                return
            task.run()
            busy = time.monotonic() - t0
            depth = self._queue.qsize()
            INGEST_METRICS.note_dequeue(depth, busy)
            self._record("ingest.dequeue", seq=task.seq, depth=depth)

    def _surplus(self) -> bool:
        with self._lock:
            alive = sum(1 for t in self._threads if t.is_alive())
            return alive > self._target_workers

    # -- autoscaling --

    def _maybe_autoscale(self) -> None:
        if not self.autoscale:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_scale < _AUTOSCALE_COOLDOWN_S:
                return
            depth = self._queue.qsize()
            n = self._target_workers
            if depth > n * _GROW_BACKLOG_PER_WORKER and n < self.max_workers:
                self._scale_locked(n + 1, now, reason="backlog", depth=depth)
                return
            if depth == 0:
                self._idle_obs += 1
                if self._idle_obs >= _SHRINK_IDLE_OBSERVATIONS and n > self.min_workers:
                    self._scale_locked(n - 1, now, reason="idle", depth=depth)
            else:
                self._idle_obs = 0

    def observe_attribution(self, host_prep_s: float, device_wait_s: float) -> None:
        """Feed the pipeline's host_prep/device_wait split to the scaler.

        Host-bound epochs (prep dominating device wait) grow the pool
        even when the queue drains between epochs — the backlog signal
        alone cannot see cross-epoch starvation.
        """
        if not self.autoscale:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._last_scale < _AUTOSCALE_COOLDOWN_S:
                return
            n = self._target_workers
            if host_prep_s > 2.0 * max(device_wait_s, 1e-9) and n < self.max_workers:
                self._scale_locked(n + 1, now, reason="host_bound", depth=self._queue.qsize())

    def _scale_locked(self, new_n: int, now: float, *, reason: str, depth: int) -> None:
        # caller holds self._lock
        old = self._target_workers
        self._target_workers = new_n
        self._last_scale = now
        self._idle_obs = 0
        INGEST_METRICS.set_workers(new_n)
        INGEST_METRICS.note_scale(new_n - old)
        self._record(
            "ingest.autoscale", workers=new_n, prev=old, reason=reason, depth=depth
        )
        if new_n > old:
            # spawn outside the lock is nicer but _ensure_workers
            # re-locks; do it lazily on next submit instead
            pass

    # -- lifecycle --

    def shutdown(self) -> None:
        self._shutdown = True
        with self._lock:
            threads = list(self._threads)
        for _ in threads:
            try:
                self._queue.put_nowait(_CHAOS_SENTINEL)
            except queue.Full:
                break
        for t in threads:
            t.join(timeout=2.0)
        with self._lock:
            self._threads = []

    @staticmethod
    def _record(kind: str, **fields: Any) -> None:
        from ..internals import flight_recorder

        flight_recorder.record(kind, **fields)


def route_by_length(
    lengths: Sequence[int], threshold: int
) -> tuple[list[int], list[int]]:
    """Split row indices into short/long groups by token length.

    Short rows batch together so one long straggler no longer
    serializes a batch of short docs; totals feed
    ``pathway_ingest_routed_{short,long}_total``.
    """
    short = [i for i, n in enumerate(lengths) if n <= threshold]
    long = [i for i, n in enumerate(lengths) if n > threshold]
    INGEST_METRICS.note_route(len(short), len(long))
    return short, long


# -- process-wide stage wiring (pw.run / env knobs) --

_STAGE: HostIngestStage | None = None
_STAGE_LOCK = threading.Lock()


def _env_workers() -> int:
    try:
        return int(os.environ.get("PATHWAY_INGEST_WORKERS", "0"))
    except ValueError:
        return 0


def configure_stage(
    workers: int | None = None, *, autoscale: bool | None = None
) -> HostIngestStage | None:
    """(Re)configure the process-wide ingest stage.

    ``workers`` ≤ 0 (or None with no env override) disables the stage.
    """
    global _STAGE
    with _STAGE_LOCK:
        if workers is None:
            workers = _env_workers()
        if autoscale is None:
            autoscale = os.environ.get("PATHWAY_INGEST_AUTOSCALE", "0") not in (
                "0",
                "",
                "false",
            )
        if _STAGE is not None:
            _STAGE.shutdown()
            _STAGE = None
        if workers and workers > 0:
            max_workers = workers
            if autoscale:
                try:
                    max_workers = int(
                        os.environ.get("PATHWAY_INGEST_MAX_WORKERS", str(max(workers, 8)))
                    )
                except ValueError:
                    max_workers = max(workers, 8)
            _STAGE = HostIngestStage(
                workers, autoscale=autoscale, max_workers=max_workers
            )
        return _STAGE


def get_stage() -> HostIngestStage | None:
    """Return the active stage, lazily honoring PATHWAY_INGEST_WORKERS."""
    global _STAGE
    with _STAGE_LOCK:
        if _STAGE is None:
            n = _env_workers()
            if n > 0:
                autoscale = os.environ.get("PATHWAY_INGEST_AUTOSCALE", "0") not in (
                    "0",
                    "",
                    "false",
                )
                _STAGE = HostIngestStage(n, autoscale=autoscale)
        return _STAGE


def shutdown_stage() -> None:
    global _STAGE
    with _STAGE_LOCK:
        if _STAGE is not None:
            _STAGE.shutdown()
            _STAGE = None
