"""Internal helpers for the LLM xpack: the port's copy of the reference's
``xpacks/llm/_utils.py`` (upstream Pathway's xpacks/llm/_utils.py): the
helpers the stores, servers and embedders use. The chat-client and
question-answering helpers come with the HTTP embedders and chat models,
ROADMAP Queue A items 1 and 2."""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable


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
