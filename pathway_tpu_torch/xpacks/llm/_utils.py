"""Internal helpers for the LLM xpack (the reference's xpacks/llm/_utils.py,
the part the embedders use)."""

from __future__ import annotations

import asyncio
import functools
from typing import Callable


def _coerce_sync(fn: Callable) -> Callable:
    """Run an async callable synchronously (or pass through sync)."""
    if asyncio.iscoroutinefunction(fn):

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return asyncio.run(fn(*args, **kwargs))

        return wrapper
    return fn
