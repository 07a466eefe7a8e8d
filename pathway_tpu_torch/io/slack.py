"""pw.io.slack: Slack alert sink.

The port's copy of the reference's ``io/slack.py`` (upstream Pathway's
python/pathway/io/slack/__init__.py send_alerts :11), on
``urllib.request``: each value of the alert column posts to a channel via
chat.postMessage. The HTTP poster is injectable (``_post``) so the loop
unit-tests without a workspace.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Callable

from ..internals.expression import ColumnReference
from ._connector import add_output_sink

_SLACK_URL = "https://slack.com/api/chat.postMessage"


def _default_post(url: str, payload: dict, token: str) -> None:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={
            "Content-Type": "application/json",
            "Authorization": f"Bearer {token}",
        },
    )
    urllib.request.urlopen(req, timeout=30).read()


def send_alerts(
    alerts: ColumnReference,
    slack_channel_id: str,
    slack_token: str,
    *,
    _post: Callable | None = None,
) -> None:
    table = alerts._table.select(message=alerts)
    post = _post or _default_post

    def on_change(key, row, time, diff):
        if diff > 0:
            post(
                _SLACK_URL,
                {"channel": slack_channel_id, "text": str(row["message"])},
                slack_token,
            )

    add_output_sink(table, on_change, name="slack.send_alerts")
