"""pw.io: connectors.

The port holds the Python connector (``pw.io.python``), subscriptions
(``pw.io.subscribe``) and ``add_output_sink``, the sink hook the other
connectors build on. The file, HTTP and service-backed connectors of the
reference come with ROADMAP Queue A item 1.
"""

from __future__ import annotations

from . import python
from ._connector import add_output_sink
from ._subscribe import OnChangeCallback, OnFinishCallback, subscribe

__all__ = ["OnChangeCallback", "OnFinishCallback", "add_output_sink", "python", "subscribe"]
