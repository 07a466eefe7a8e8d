"""pw.io.redpanda: Redpanda connector.

The port's copy of the reference's ``io/redpanda.py``. Redpanda speaks
the Kafka protocol, so this module is a thin alias of ``pw.io.kafka``,
exactly like upstream Pathway's python/pathway/io/redpanda/__init__.py.
"""

from __future__ import annotations

from .kafka import read, write  # noqa: F401
