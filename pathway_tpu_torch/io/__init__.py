"""pw.io: connectors.

The port holds the file connectors (``fs``, ``csv``, ``jsonlines``,
``plaintext``, ``null``), the REST server connector and the HTTP client
connectors (``http``), the Python connector (``pw.io.python``),
subscriptions (``pw.io.subscribe``) and ``add_output_sink``, the sink hook
the other connectors build on. The service-backed connectors of the
reference come with ROADMAP Queue A item 1.
"""

from __future__ import annotations

from . import csv, fs, http, jsonlines, null, plaintext, python
from ._connector import add_output_sink
from ._formats import CsvParserSettings
from ._subscribe import OnChangeCallback, OnFinishCallback, subscribe

__all__ = [
    "CsvParserSettings",
    "OnChangeCallback",
    "OnFinishCallback",
    "add_output_sink",
    "csv",
    "fs",
    "http",
    "jsonlines",
    "null",
    "plaintext",
    "python",
    "subscribe",
]
