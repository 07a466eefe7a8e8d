"""Shared type aliases for the LLM xpack.

The port's copy of the reference's ``xpacks/llm/_typing.py`` (upstream
Pathway's python/pathway/xpacks/llm/_typing.py).
"""

from __future__ import annotations

from typing import Callable, Iterable, TypeAlias, Union

from ...internals.udfs import UDF

#: A parsed / chunked document: {"text": ..., "metadata": {...}}
Doc: TypeAlias = dict[str, str | dict]

DocTransformerCallable: TypeAlias = Union[
    Callable[[Iterable[Doc]], Iterable[Doc]],
    Callable[[Iterable[Doc], float], Iterable[Doc]],
]

DocTransformer: TypeAlias = Union[UDF, DocTransformerCallable]
