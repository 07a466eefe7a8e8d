"""AsyncTransformer (reference stdlib/utils/async_transformer.py:61-282):
fully-async row transformer with invoke() coroutine and a result table.

Failures of ``invoke`` route to a real ``.failed`` dead-letter table by
default (``on_error="dead_letter"``): the offending row drops from
``.successful`` and lands in ``.failed`` with its input values, the
operator id, the error message and a trace. The ``open()``/``close()``
lifecycle hooks are honored around retries: ``open()`` runs lazily
before the first ``invoke`` (after graph build, on the delivering
process), retries re-enter ``invoke`` without reopening, and
``close()`` fires once when the node's input stream ends.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Any

from ...internals import dtype as dt
from ...internals.expression import AsyncApplyExpression, MakeTupleExpression
from ...internals.schema import Schema
from ...internals.table import Table
from ...internals.udfs import AsyncRetryStrategy, coerce_async
from ...resilience import chaos

# the commit point of every async UDF plane: between invoke() resolving
# and the engine making the row durable — a raise here must route to
# the node's on_error path, which is what chaos runs verify and what
# the deep verifier (PWL020) requires a registered site for
chaos.register_site("udf.async_commit", "udf")


class AsyncTransformer:
    """Subclass with an output schema and an async invoke():

        class MyT(pw.AsyncTransformer, output_schema=OutSchema):
            async def invoke(self, value: str) -> dict: ...

        result = MyT(input_table=t).successful
        errors = MyT(input_table=t).failed

    ``retry_strategy`` may be a ``udfs.AsyncRetryStrategy`` or a shared
    :class:`pathway_tpu_torch.resilience.RetryPolicy`; ``on_error`` picks what
    happens after retries are exhausted: ``"dead_letter"`` (default —
    row moves to ``.failed``), ``"raise"`` (terminate_on_error routing),
    or ``"skip"`` (drop silently).
    """

    output_schema: type[Schema]

    def __init_subclass__(cls, /, output_schema: type[Schema] | None = None, **kwargs):
        super().__init_subclass__(**kwargs)
        if output_schema is not None:
            cls.output_schema = output_schema

    def __init__(
        self,
        input_table: Table,
        *,
        instance=None,
        autocommit_duration_ms=None,
        name=None,
        retry_strategy: Any = None,
        on_error: str = "dead_letter",
    ):
        if on_error not in ("raise", "dead_letter", "skip"):
            raise ValueError(
                f"on_error={on_error!r}: expected 'raise', 'dead_letter' or 'skip'"
            )
        self._input_table = input_table
        self._retry_strategy = retry_strategy
        self._on_error = on_error
        self._dl_id: int | None = None
        self._result_table: Table | None = None
        self._failed_table: Table | None = None

    async def invoke(self, *args, **kwargs) -> dict:
        raise NotImplementedError

    def open(self) -> None:
        """Called once before the first ``invoke`` of the run (lazily, on
        the process that executes the transformer)."""

    def close(self) -> None:
        """Called once when the input stream ends (only if ``open`` ran)."""

    @property
    def successful(self) -> Table:
        return self.result

    def _dead_letter_id(self) -> int:
        if self._dl_id is None:
            from ...internals.errors import new_dead_letter_id

            self._dl_id = new_dead_letter_id()
        return self._dl_id

    @property
    def failed(self) -> Table:
        """Dead-letter table of rows whose ``invoke`` raised (after
        retries): columns ``args`` (JSON of the input values),
        ``operator_id``, ``message``, ``trace``."""
        if self._failed_table is None:
            from ...internals.errors import dead_letter_table

            self._failed_table = dead_letter_table(
                self._dead_letter_id(), name=f"{type(self).__name__}.failed"
            )
        return self._failed_table

    @property
    def finished(self) -> Table:
        return self.result

    def _result_names(self) -> list[str]:
        return list(self.output_schema.dtypes().keys())

    @property
    def result(self) -> Table:
        # cached: .successful / .finished / repeated access must reuse
        # ONE operator chain (one open()/close() lifecycle, one node)
        if self._result_table is not None:
            return self._result_table
        table = self._input_table
        names = table.column_names()
        out_names = self._result_names()
        dtypes = self.output_schema.dtypes()

        # open() runs lazily before the first invoke — NOT at graph
        # build: worker processes that never execute the transformer
        # must not acquire its resources. The lock serializes the
        # first concurrent batch; retries never re-open.
        lifecycle = {"opened": False}
        open_lock = threading.Lock()

        def _ensure_open():
            if not lifecycle["opened"]:
                with open_lock:
                    if not lifecycle["opened"]:
                        self.open()
                        lifecycle["opened"] = True

        async def call(*values):
            _ensure_open()
            kwargs = dict(zip(names, values))
            result = await self.invoke(**kwargs)
            chaos.inject("udf.async_commit")
            return tuple(result.get(n) for n in out_names)

        wrapped = call
        strategy = self._retry_strategy
        if strategy is not None:
            if not isinstance(strategy, AsyncRetryStrategy):
                as_async = getattr(strategy, "as_async_strategy", None)
                if as_async is not None:
                    strategy = as_async(f"async_transformer:{type(self).__name__}")
            from ...internals.udfs import with_retry_strategy

            wrapped = with_retry_strategy(call, strategy)

        def _close():
            # multi-shard runs lower one node per worker engine; close
            # exactly once, and only if open actually ran
            with open_lock:
                if lifecycle["opened"]:
                    lifecycle["opened"] = False
                    self.close()

        tuple_expr = AsyncApplyExpression(
            wrapped, dt.Tuple(*[dtypes[n] for n in out_names]),
            tuple(table[n] for n in names), {},
        )
        if self._on_error != "raise":
            tuple_expr._pw_on_error = self._on_error
            if self._on_error == "dead_letter":
                tuple_expr._pw_dead_letter_id = self._dead_letter_id()
        tuple_expr._pw_on_end = _close
        packed = table.select(_pw_packed=tuple_expr)
        from ...internals.expression import DeclareTypeExpression

        self._result_table = packed.select(
            **{
                n: DeclareTypeExpression(dtypes[n], packed._pw_packed[i])
                for i, n in enumerate(out_names)
            }
        )
        return self._result_table


__all__ = ["AsyncTransformer"]
