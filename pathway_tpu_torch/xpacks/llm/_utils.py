"""Internal helpers for the LLM xpack: the port's copy of the reference's
``xpacks/llm/_utils.py`` (upstream Pathway's xpacks/llm/_utils.py): the
helpers the stores, servers, embedders, chats, rerankers and
question-answering apps use. ``openai`` is imported only when a client is
made."""

from __future__ import annotations

import asyncio
import functools
import weakref
from typing import Any, Callable

from ...engine.value import Json


def coerce_async(fn: Callable) -> Callable:
    """Wrap a sync callable (or pass through an async one) so it can be
    awaited. UDF instances are unwrapped to their __wrapped__."""
    from ...internals.udfs import UDF

    if isinstance(fn, UDF):
        inner = fn.func if fn.func is not None else fn.__wrapped__
        return coerce_async(inner)
    if asyncio.iscoroutinefunction(fn):
        return fn

    @functools.wraps(fn)
    async def wrapper(*args, **kwargs):
        return fn(*args, **kwargs)

    return wrapper


def _unwrap_udf(fn: Any) -> Callable:
    """Return the plain callable behind a UDF (or the callable itself)."""
    from ...internals.udfs import UDF

    if isinstance(fn, UDF):
        return fn.func if fn.func is not None else fn.__wrapped__
    return fn


def _coerce_sync(fn: Callable) -> Callable:
    """Run an async callable synchronously (or pass through sync)."""
    if asyncio.iscoroutinefunction(fn):

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return asyncio.run(fn(*args, **kwargs))

        return wrapper
    return fn


def _run_async(coro):
    """Run a coroutine to completion from sync code, safely even when a
    loop is already running in this thread (reference _utils._run_async):
    nested-loop cases hop to a throwaway thread."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(asyncio.run, coro).result()


def combine_metadata_filters(queries) -> Any:
    """Fold metadata_filter + filepath_globpattern columns into one
    JMESPath expression column (reference vector_store.py:359)."""
    from ...internals.thisclass import this
    from ...internals.udfs import udf

    @udf
    def _get_jmespath_filter(metadata_filter, filepath_globpattern) -> str | None:
        ret_parts = []
        if metadata_filter:
            metadata_filter = (
                str(metadata_filter)
                .replace("'", r"\'")
                .replace("`", "'")
                .replace('"', "")
            )
            ret_parts.append(f"({metadata_filter})")
        if filepath_globpattern:
            ret_parts.append(f"globmatch('{filepath_globpattern}', path)")
        if ret_parts:
            return " && ".join(ret_parts)
        return None

    return queries.without("metadata_filter", "filepath_globpattern") + queries.select(
        metadata_filter=_get_jmespath_filter(
            this.metadata_filter, this.filepath_globpattern
        )
    )


# per-event-loop client pools, weak-keyed so a finished run's loop (and
# its clients' dead connection pools) drop out instead of being handed
# to a later loop that reused the same address
_openai_clients: "weakref.WeakKeyDictionary[Any, dict]" = weakref.WeakKeyDictionary()
_openai_clients_noloop: dict[tuple, Any] = {}


def shared_openai_client(api_key: str | None, base_url: str | None):
    """One AsyncOpenAI client per (event loop, api_key, base_url):
    clients own HTTP connection pools, so per-call construction leaks
    sockets and defeats keep-alive under the async executor's
    concurrency — but a client's pool is bound to the loop it was
    created on, so each run's loop gets its own."""
    import openai

    try:
        loop = asyncio.get_running_loop()
        pool = _openai_clients.setdefault(loop, {})
    except RuntimeError:
        pool = _openai_clients_noloop
    key = (api_key, base_url)
    client = pool.get(key)
    if client is None:
        client = openai.AsyncOpenAI(api_key=api_key, base_url=base_url)
        pool[key] = client
    return client


def _check_model_accepts_arg(model_name: str, provider: str, arg: str) -> bool:
    """Best-effort capability check; without network metadata we accept
    common sampling args for all models."""
    return arg in {
        "temperature",
        "max_tokens",
        "top_p",
        "stop",
        "seed",
        "frequency_penalty",
        "presence_penalty",
    }
