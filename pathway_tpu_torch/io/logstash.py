"""pw.io.logstash: Logstash HTTP sink.

The port's copy of the reference's ``io/logstash.py`` (upstream Pathway's
python/pathway/io/logstash/__init__.py write :14), on ``urllib.request``:
POST each change as a JSON document (row + time/diff) to the Logstash
HTTP input plugin endpoint. The HTTP poster is injectable (``_post``) so
the loop unit-tests without a server.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Callable

from ..internals.table import Table
from ._connector import add_output_sink
from ._formats import JsonLinesFormatter


def _default_post(endpoint: str, payload: bytes) -> None:
    req = urllib.request.Request(
        endpoint, data=payload, headers={"Content-Type": "application/json"}
    )
    urllib.request.urlopen(req, timeout=30).read()


def write(
    table: Table,
    endpoint: str,
    n_retries: int = 0,
    retry_policy=None,
    *,
    _post: Callable | None = None,
) -> None:
    """``retry_policy``: an object with ``sleep_duration_ms(attempt)``
    (or a callable attempt -> delay ms) spacing the retries; None
    retries immediately."""
    import time as _time

    fmt = JsonLinesFormatter(table.column_names())
    post = _post or _default_post

    def delay_ms(attempt: int) -> float:
        if retry_policy is None:
            return 0.0
        if hasattr(retry_policy, "sleep_duration_ms"):
            return float(retry_policy.sleep_duration_ms(attempt))
        if callable(retry_policy):
            return float(retry_policy(attempt))
        raise TypeError(
            "retry_policy must expose sleep_duration_ms(attempt) or be callable"
        )

    def on_change(key, row, time, diff):
        payload = fmt.format(row, time, diff).encode()
        last_exc = None
        for attempt in range(n_retries + 1):
            try:
                post(endpoint, payload)
                return
            except Exception as e:  # noqa: BLE001 — retried, then re-raised
                last_exc = e
                if attempt < n_retries:
                    d = delay_ms(attempt)
                    if d > 0:
                        _time.sleep(d / 1000.0)
        raise last_exc

    add_output_sink(table, on_change, name="logstash.write")
