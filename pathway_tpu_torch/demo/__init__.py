"""pw.demo: synthetic streams (reference python/pathway/demo/__init__.py:
generate_custom_stream :28, range_stream, noisy_linear_stream,
replay_csv :339)."""

from __future__ import annotations

import csv as _csv
import time
from typing import Any, Callable

from ..internals import dtype as dt
from ..internals.schema import Schema, schema_builder, ColumnDefinition
from ..internals.table import Table
from ..io._connector import StreamingContext, input_table_from_reader
from ..io import python as io_python


def generate_custom_stream(
    value_generators: dict[str, Callable[[int], Any]],
    *,
    schema: type[Schema],
    nb_rows: int | None = None,
    input_rate: float = 1.0,
    autocommit_duration_ms: int = 1000,
    name: str = "demo",
) -> Table:
    """Stream rows produced by per-column generators fed the row index."""

    def reader(ctx: StreamingContext) -> None:
        i = 0
        while nb_rows is None or i < nb_rows:
            ctx.insert({k: gen(i) for k, gen in value_generators.items()})
            ctx.commit()
            i += 1
            if input_rate > 0:
                time.sleep(1.0 / input_rate)

    return input_table_from_reader(
        schema, reader, name=name, autocommit_duration_ms=autocommit_duration_ms
    )


def range_stream(
    nb_rows: int | None = None,
    offset: int = 0,
    input_rate: float = 1.0,
    autocommit_duration_ms: int = 1000,
) -> Table:
    schema = schema_builder({"value": ColumnDefinition(dtype=dt.INT)}, name="RangeSchema")
    return generate_custom_stream(
        {"value": lambda i: i + offset},
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
        autocommit_duration_ms=autocommit_duration_ms,
        name="range_stream",
    )


def noisy_linear_stream(nb_rows: int = 10, input_rate: float = 1.0) -> Table:
    import random

    schema = schema_builder(
        {"x": ColumnDefinition(dtype=dt.FLOAT), "y": ColumnDefinition(dtype=dt.FLOAT)},
        name="NoisyLinear",
    )
    return generate_custom_stream(
        {
            "x": lambda i: float(i),
            "y": lambda i: float(i) + random.uniform(-1, 1),
        },
        schema=schema,
        nb_rows=nb_rows,
        input_rate=input_rate,
        name="noisy_linear",
    )


def replay_csv(
    path: str,
    *,
    schema: type[Schema],
    input_rate: float = 1.0,
) -> Table:
    """Replay a CSV file as a stream at input_rate rows/sec."""

    def reader(ctx: StreamingContext) -> None:
        with open(path, newline="") as f:
            for rec in _csv.DictReader(f):
                ctx.insert(dict(rec))
                ctx.commit()
                if input_rate > 0:
                    time.sleep(1.0 / input_rate)

    return input_table_from_reader(schema, reader, name=f"replay:{path}")


def replay_csv_with_time(
    path: str,
    *,
    schema: type[Schema],
    time_column: str,
    unit: str = "s",
    autocommit_ms: int = 100,
    speedup: float = 1.0,
) -> Table:
    """Replay a CSV using a time column to pace the stream."""
    mult = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}[unit]

    def reader(ctx: StreamingContext) -> None:
        prev_t = None
        with open(path, newline="") as f:
            for rec in _csv.DictReader(f):
                t = float(rec[time_column]) * mult
                if prev_t is not None and t > prev_t:
                    time.sleep((t - prev_t) / speedup)
                prev_t = t
                ctx.insert(dict(rec))
                ctx.commit()

    return input_table_from_reader(schema, reader, name=f"replay_t:{path}")
