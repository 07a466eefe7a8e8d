"""UDF system: @pw.udf, executors, caches, retries.

Rebuild of upstream Pathway's python/pathway/internals/udfs/ (__init__.py:68
UDF base + decorator, executors.py:20-311, caches.py:23-120, retries.py).
The async executor batches concurrent calls per engine epoch — on TPU this
is the path that feeds jit-batched models (pathway_tpu.xpacks.llm)."""

from __future__ import annotations

import asyncio
import functools
import hashlib
import inspect
import os
import pickle
import random
import time as _time
from typing import Any, Callable

from ..expression import (
    ApplyExpression,
    AsyncApplyExpression,
    ColumnExpression,
    FullyAsyncApplyExpression,
)

__all__ = [
    "UDF",
    "udf",
    "auto_executor",
    "sync_executor",
    "async_executor",
    "fully_async_executor",
    "batch_executor",
    "coerce_async",
    "with_cache_strategy",
    "with_retry_strategy",
    "with_capacity",
    "with_timeout",
    "CacheStrategy",
    "DefaultCache",
    "DiskCache",
    "InMemoryCache",
    "AsyncRetryStrategy",
    "ExponentialBackoffRetryStrategy",
    "FixedDelayRetryStrategy",
    "NoRetryStrategy",
]


# ---------------- retries (reference udfs/retries.py) ----------------


class AsyncRetryStrategy:
    async def invoke(self, fn: Callable, *args, **kwargs):
        raise NotImplementedError


class NoRetryStrategy(AsyncRetryStrategy):
    async def invoke(self, fn, *args, **kwargs):
        return await fn(*args, **kwargs)


class ExponentialBackoffRetryStrategy(AsyncRetryStrategy):
    def __init__(
        self,
        max_retries: int = 3,
        initial_delay: int = 1_000,
        backoff_factor: float = 2.0,
        jitter_ms: int = 300,
        rng: random.Random | None = None,
    ):
        self.max_retries = max_retries
        self.initial_delay = initial_delay / 1000.0
        self.backoff_factor = backoff_factor
        self.jitter = jitter_ms / 1000.0
        # injectable RNG (e.g. random.Random(seed)) makes the jitter
        # sequence deterministic for tests; default keeps fleet
        # de-synchronization via the module-global generator
        self._rng = rng if rng is not None else random

    async def invoke(self, fn, *args, **kwargs):
        delay = self.initial_delay
        for attempt in range(self.max_retries + 1):
            try:
                return await fn(*args, **kwargs)
            except Exception:
                if attempt == self.max_retries:
                    raise
                await asyncio.sleep(delay + self._rng.random() * self.jitter)
                delay *= self.backoff_factor


class FixedDelayRetryStrategy(ExponentialBackoffRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1_000):
        super().__init__(max_retries, delay_ms, 1.0, 0)


# ---------------- caches (reference udfs/caches.py) ----------------


class CacheStrategy:
    def key(self, fn_name: str, args, kwargs) -> str:
        payload = pickle.dumps((args, tuple(sorted(kwargs.items()))))
        return fn_name + "-" + hashlib.sha256(payload).hexdigest()

    async def invoke(self, key: str, fn: Callable, *args, **kwargs):
        raise NotImplementedError


class InMemoryCache(CacheStrategy):
    def __init__(self):
        self._store: dict[str, Any] = {}

    async def invoke(self, key, fn, *args, **kwargs):
        if key not in self._store:
            self._store[key] = await fn(*args, **kwargs)
        return self._store[key]


class DiskCache(CacheStrategy):
    def __init__(self, name: str | None = None, size_limit: int | None = None):
        self.name = name
        base = os.environ.get(
            "PATHWAY_PERSISTENT_STORAGE", os.path.expanduser("~/.cache/pathway_tpu")
        )
        self.dir = os.path.join(base, "udf_cache", name or "default")
        os.makedirs(self.dir, exist_ok=True)

    async def invoke(self, key, fn, *args, **kwargs):
        path = os.path.join(self.dir, key[:200])
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        result = await fn(*args, **kwargs)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, path)
        return result


DefaultCache = DiskCache


# ---------------- executors (reference udfs/executors.py) ----------------


class Executor:
    kind = "auto"


class AutoExecutor(Executor):
    kind = "auto"


class SyncExecutor(Executor):
    kind = "sync"


class AsyncExecutor(Executor):
    kind = "async"

    def __init__(
        self,
        *,
        capacity: int | None = None,
        timeout: float | None = None,
        retry_strategy: AsyncRetryStrategy | None = None,
    ):
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy


class FullyAsyncExecutor(AsyncExecutor):
    kind = "fully_async"


class BatchExecutor(Executor):
    """An addition over the reference: the UDF receives columnar batches
    (list-of-args per parameter) and returns a list of results. Calls
    issued concurrently within an engine epoch are dynamically batched —
    this is how jit-compiled models see full batches instead of rows."""

    kind = "batch"

    def __init__(self, max_batch_size: int = 1024, linger_ms: float = 0.0):
        self.max_batch_size = max_batch_size
        self.linger_ms = linger_ms


def auto_executor() -> Executor:
    return AutoExecutor()


def sync_executor() -> Executor:
    return SyncExecutor()


def _coerce_retry_strategy(retry_strategy: Any) -> AsyncRetryStrategy | None:
    """Accept either an AsyncRetryStrategy or a shared
    pathway_tpu.resilience.RetryPolicy (duck-typed via its
    as_async_strategy adapter) — one retry knob across the runtime."""
    if retry_strategy is None or isinstance(retry_strategy, AsyncRetryStrategy):
        return retry_strategy
    as_async = getattr(retry_strategy, "as_async_strategy", None)
    if as_async is not None:
        return as_async()
    return retry_strategy


def async_executor(
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: Any = None,
) -> Executor:
    """``retry_strategy`` may be an :class:`AsyncRetryStrategy` or a
    :class:`pathway_tpu.resilience.RetryPolicy` (attempt counts then
    land in ``resilience.RETRY_METRICS`` → ``/metrics``)."""
    return AsyncExecutor(
        capacity=capacity,
        timeout=timeout,
        retry_strategy=_coerce_retry_strategy(retry_strategy),
    )


def fully_async_executor(
    *,
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: Any = None,
) -> Executor:
    return FullyAsyncExecutor(
        capacity=capacity,
        timeout=timeout,
        retry_strategy=_coerce_retry_strategy(retry_strategy),
    )


def batch_executor(*, max_batch_size: int = 1024, linger_ms: float = 0.0) -> Executor:
    return BatchExecutor(max_batch_size=max_batch_size, linger_ms=linger_ms)


def coerce_async(fn: Callable) -> Callable:
    """Wrap a sync function as async (runs inline; reference coerce_async)."""
    if asyncio.iscoroutinefunction(fn):
        return fn

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return wrapper


async def _with_timeout(coro_fn, timeout, *args, **kwargs):
    return await asyncio.wait_for(coro_fn(*args, **kwargs), timeout)


def with_cache_strategy(fn: Callable, cache: CacheStrategy) -> Callable:
    afn = coerce_async(fn)
    name = getattr(fn, "__name__", "udf")

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        key = cache.key(name, args, kwargs)
        return await cache.invoke(key, afn, *args, **kwargs)

    return wrapper


def with_retry_strategy(fn: Callable, retry_strategy: AsyncRetryStrategy) -> Callable:
    afn = coerce_async(fn)

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        return await retry_strategy.invoke(afn, *args, **kwargs)

    return wrapper


def with_capacity(fn: Callable, capacity: int) -> Callable:
    afn = coerce_async(fn)
    sem_holder: dict[int, asyncio.Semaphore] = {}

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        loop_id = id(asyncio.get_running_loop())
        sem = sem_holder.get(loop_id)
        if sem is None:
            sem = sem_holder[loop_id] = asyncio.Semaphore(capacity)
        async with sem:
            return await afn(*args, **kwargs)

    return wrapper


def with_propagate_none(fn: Callable) -> Callable:
    """Skip the call (return None) when any argument is None
    (reference UDF propagate_none semantics)."""
    afn = coerce_async(fn)

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        if any(a is None for a in args) or any(v is None for v in kwargs.values()):
            return None
        return await afn(*args, **kwargs)

    return wrapper


def with_timeout(fn: Callable, timeout: float) -> Callable:
    afn = coerce_async(fn)

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        return await asyncio.wait_for(afn(*args, **kwargs), timeout)

    return wrapper


def unwrap_udf(fn: Any) -> Callable:
    """The plain callable behind a UDF (or the callable itself)."""
    if isinstance(fn, UDF):
        return fn.func if fn.func is not None else fn.__wrapped__
    return fn


def as_batch_callable(embedder: Any) -> Callable:
    """Adapt a UDF or plain callable into `texts -> results` for host-side
    batch use (index builds, dimension probing).

    Preserves the UDF's executor policies: async UDFs keep their retry /
    timeout / capacity wrappers and cache strategy, and the whole batch
    runs under one event loop via asyncio.gather instead of one
    asyncio.run per item. BatchExecutor UDFs call their function once
    with the full list. Plain callables are assumed batch-capable."""
    if not isinstance(embedder, UDF):
        return embedder
    inner = unwrap_udf(embedder)
    ex = embedder.executor

    if isinstance(ex, BatchExecutor):
        def run_batch(items):
            return inner(list(items))

        return run_batch

    if asyncio.iscoroutinefunction(inner) or isinstance(ex, AsyncExecutor):
        wrapped = coerce_async(inner)
        if isinstance(ex, AsyncExecutor):
            if ex.retry_strategy is not None:
                wrapped = with_retry_strategy(wrapped, ex.retry_strategy)
            if ex.timeout is not None:
                wrapped = with_timeout(wrapped, ex.timeout)
            if ex.capacity is not None:
                wrapped = with_capacity(wrapped, ex.capacity)
        if embedder.cache_strategy is not None:
            wrapped = with_cache_strategy(wrapped, embedder.cache_strategy)

        def run_gathered(items):
            async def run_all():
                return list(
                    await asyncio.gather(*[wrapped(item) for item in items])
                )

            return asyncio.run(run_all())

        return run_gathered

    def run_items(items):
        return [inner(item) for item in items]

    return run_items


class _DynamicBatcher:
    """Collects concurrent calls into one batch invocation of the
    underlying columnar function. All calls gathered within an epoch's
    asyncio.gather land in the same batch (up to max_batch_size)."""

    def __init__(self, batch_fn: Callable, max_batch_size: int, linger_ms: float):
        self.batch_fn = batch_fn
        self.max_batch_size = max_batch_size
        self.linger_s = linger_ms / 1000.0
        self._pending: list[tuple[tuple, dict, asyncio.Future]] = []
        self._task: asyncio.Task | None = None

    async def __call__(self, *args, **kwargs):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending.append((args, kwargs, fut))
        if len(self._pending) >= self.max_batch_size:
            self._flush()
        elif self._task is None or self._task.done():
            self._task = loop.create_task(self._linger_flush())
        return await fut

    async def _linger_flush(self):
        # yield so every coroutine scheduled by the same gather() enqueues
        await asyncio.sleep(self.linger_s)
        self._flush()

    def _flush(self):
        if not self._pending:
            return
        batch = self._pending[: self.max_batch_size]
        self._pending = self._pending[self.max_batch_size :]
        args_cols = list(zip(*[a for a, _, _ in batch])) if batch else []
        arg_lists = [list(col) for col in args_cols]
        try:
            results = self.batch_fn(*arg_lists)
            if len(results) != len(batch):
                raise ValueError(
                    f"batch UDF returned {len(results)} results for {len(batch)} inputs"
                )
            for (_, _, fut), res in zip(batch, results):
                if not fut.done():
                    fut.set_result(res)
        except Exception as exc:
            for _, _, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)
        if self._pending:
            self._flush()


class UDF:
    """Base class / wrapper for user-defined functions
    (reference udfs/__init__.py:68)."""

    def __init__(
        self,
        func: Callable | None = None,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        max_batch_size: int | None = None,
        on_error: str = "raise",
    ):
        if on_error not in ("raise", "dead_letter", "skip"):
            raise ValueError(
                f"on_error={on_error!r}: expected 'raise', 'dead_letter' or 'skip'"
            )
        self.func = func
        self.return_type = return_type
        self.deterministic = deterministic
        self.propagate_none = propagate_none
        self.executor = executor or AutoExecutor()
        self.cache_strategy = cache_strategy
        self.max_batch_size = max_batch_size
        self.on_error = on_error
        self._dl_id: int | None = None
        if func is not None:
            # update_wrapper sets self.__wrapped__ = func; guarded so a
            # subclass-defined __wrapped__ method is not shadowed by None
            functools.update_wrapper(self, func)

    # subclasses may override instead of passing func
    def __call__(self, *args, **kwargs) -> ColumnExpression:
        fn = self.func if self.func is not None else getattr(self, "__wrapped__", None)
        if fn is None:
            raise TypeError("UDF has no function; override __wrapped__ or pass func")
        return self._build_expression(fn, args, kwargs)

    def _dead_letter_id(self) -> int:
        if self._dl_id is None:
            from ..errors import new_dead_letter_id

            self._dl_id = new_dead_letter_id()
        return self._dl_id

    @property
    def failed(self):
        """Dead-letter table: rows this UDF failed on (requires
        ``on_error="dead_letter"``), shaped as
        :class:`pathway_tpu.internals.errors.DeadLetterSchema`."""
        from ..errors import dead_letter_table

        name = getattr(self, "__name__", None) or "udf"
        return dead_letter_table(self._dead_letter_id(), name=f"{name}.failed")

    def _stamp_policy(self, expr: ColumnExpression) -> ColumnExpression:
        """Attach the row-failure policy to the built expression; the
        graph runner copies it onto the engine node."""
        if self.on_error != "raise":
            expr._pw_on_error = self.on_error
            if self.on_error == "dead_letter":
                expr._pw_dead_letter_id = self._dead_letter_id()
        return expr

    def _build_expression(self, fn, args, kwargs) -> ColumnExpression:
        ret = self.return_type
        if ret is None:
            try:
                hints = inspect.get_annotations(fn, eval_str=True)
                ret = hints.get("return")
            except Exception:
                ret = None

        ex = self.executor
        is_async = asyncio.iscoroutinefunction(fn)

        if isinstance(ex, BatchExecutor):
            batched = _DynamicBatcher(fn, ex.max_batch_size, ex.linger_ms)
            wrapped = batched
            if self.cache_strategy is not None:
                wrapped = with_cache_strategy(wrapped, self.cache_strategy)
            if self.propagate_none:
                wrapped = with_propagate_none(wrapped)
            return self._stamp_policy(AsyncApplyExpression(wrapped, ret, args, kwargs))

        if isinstance(ex, AsyncExecutor) or is_async or (
            isinstance(ex, AutoExecutor) and is_async
        ):
            wrapped = coerce_async(fn)
            if self.propagate_none:
                wrapped = with_propagate_none(wrapped)
            if isinstance(ex, AsyncExecutor):
                if ex.retry_strategy is not None:
                    wrapped = with_retry_strategy(wrapped, ex.retry_strategy)
                if ex.timeout is not None:
                    wrapped = with_timeout(wrapped, ex.timeout)
                if ex.capacity is not None:
                    wrapped = with_capacity(wrapped, ex.capacity)
            if self.cache_strategy is not None:
                wrapped = with_cache_strategy(wrapped, self.cache_strategy)
            cls = (
                FullyAsyncApplyExpression
                if isinstance(ex, FullyAsyncExecutor)
                else AsyncApplyExpression
            )
            return self._stamp_policy(cls(wrapped, ret, args, kwargs))

        # sync path
        fn_sync = fn
        if self.cache_strategy is not None:
            cached = with_cache_strategy(fn, self.cache_strategy)
            if self.propagate_none:
                cached = with_propagate_none(cached)
            return self._stamp_policy(AsyncApplyExpression(cached, ret, args, kwargs))
        if self.on_error != "raise":
            # dead-letter/skip routing lives on the Async/BatchApply
            # engine nodes — lift the sync fn onto that path
            wrapped = coerce_async(fn)
            if self.propagate_none:
                wrapped = with_propagate_none(wrapped)
            return self._stamp_policy(AsyncApplyExpression(wrapped, ret, args, kwargs))
        return ApplyExpression(
            fn_sync,
            ret,
            args,
            kwargs,
            propagate_none=self.propagate_none,
            deterministic=self.deterministic,
        )


def udf(
    fun: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
    max_batch_size: int | None = None,
    on_error: str = "raise",
):
    """Decorator: turn a python function into a UDF usable in expressions
    (reference udfs/__init__.py:290 `pw.udf`).

    ``on_error``: per-row failure policy — ``"raise"`` (default,
    terminate_on_error routing), ``"dead_letter"`` (failing rows drop
    from the output and land in the UDF's ``.failed`` table with error
    message, node id and trace), or ``"skip"`` (drop silently)."""

    def wrapper(f):
        return UDF(
            f,
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=executor,
            cache_strategy=cache_strategy,
            max_batch_size=max_batch_size,
            on_error=on_error,
        )

    if fun is not None:
        return wrapper(fun)
    return wrapper


# ---- deprecated aliases kept for reference-code migration ----
# (reference udfs/__init__.py UDFSync :214, UDFFunction :231,
# UDFAsync :405, udf_async :449, executors.py async_options :286)


def async_options(
    capacity: int | None = None,
    timeout: float | None = None,
    retry_strategy: AsyncRetryStrategy | None = None,
    cache_strategy: "CacheStrategy | None" = None,
):
    """Decorator wrapping a plain function to run under the async
    executor with the given concurrency/timeout/retry/cache options."""

    def wrapper(fun):
        return udf(
            fun,
            executor=async_executor(
                capacity=capacity, timeout=timeout, retry_strategy=retry_strategy
            ),
            cache_strategy=cache_strategy,
        )

    return wrapper


class UDFSync(UDF):
    """Deprecated: use ``UDF`` (sync is the default executor)."""

    def __init_subclass__(cls, **kwargs):
        import warnings

        warnings.warn(
            "UDFSync is deprecated, subclass UDF instead", DeprecationWarning
        )
        super().__init_subclass__(**kwargs)


UDFFunction = UDF


class UDFAsync(UDF):
    """Deprecated: use ``UDF`` with ``executor=async_executor()``."""

    def __init__(self, *args, capacity=None, retry_strategy=None, **kwargs):
        import warnings

        warnings.warn(
            "UDFAsync is deprecated, use UDF with executor=pw.udfs.async_executor()",
            DeprecationWarning,
        )
        kwargs.setdefault(
            "executor",
            async_executor(capacity=capacity, retry_strategy=retry_strategy),
        )
        super().__init__(*args, **kwargs)


def udf_async(fun=None, **kwargs):
    """Deprecated: use ``pw.udf`` with ``executor=async_executor()``."""
    import warnings

    warnings.warn(
        "udf_async is deprecated, use pw.udf with executor=pw.udfs.async_executor()",
        DeprecationWarning,
    )
    if fun is not None:
        return udf(fun, executor=async_executor(), **kwargs)
    return lambda f: udf(f, executor=async_executor(), **kwargs)


__all__ += [
    "UDFAsync",
    "UDFFunction",
    "UDFSync",
    "async_options",
    "udf_async",
]
