"""pw.io.pubsub: Google Cloud Pub/Sub sink.

The port's copy of the reference's ``io/pubsub.py`` (upstream Pathway's
python/pathway/io/pubsub/__init__.py write :49 with _OutputBuffer :11):
each change publishes a message whose data is the JSON row and whose
attributes carry the pathway time/diff metadata. The publisher is
injectable (``_publisher``) so the loop unit-tests against a fake;
google-cloud-pubsub is only needed for real topics.
"""

from __future__ import annotations

import json
from typing import Any

from ..internals.table import Table
from ._connector import add_output_sink
from ._formats import jsonable_value


def write(
    table: Table,
    publisher: Any = None,
    project_id: str | None = None,
    topic_id: str | None = None,
    *,
    _publisher: Any = None,
) -> None:
    names = table.column_names()
    state: dict = {"futures": []}
    pub = _publisher if _publisher is not None else publisher

    def on_build(runner):
        if pub is not None:
            state["pub"] = pub
        else:
            try:
                from google.cloud import pubsub_v1  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "pw.io.pubsub requires the 'google-cloud-pubsub' package"
                ) from e
            state["pub"] = pubsub_v1.PublisherClient()
        state["topic"] = state["pub"].topic_path(project_id, topic_id)

    def on_change(key, row, time, diff):
        data = json.dumps({n: jsonable_value(row[n]) for n in names}).encode()
        fut = state["pub"].publish(
            state["topic"],
            data,
            pathway_time=str(time),
            pathway_diff=str(diff),
        )
        state["futures"].append(fut)
        if len(state["futures"]) >= 1000:
            # resolve in-flight publishes so a streaming run's future
            # list stays bounded
            for f in state["futures"]:
                if hasattr(f, "result"):
                    f.result()
            state["futures"] = []

    def on_end():
        for fut in state["futures"]:
            if hasattr(fut, "result"):
                fut.result()
        state["futures"] = []

    add_output_sink(
        table, on_change, on_end=on_end, name="pubsub.write", on_build=on_build
    )
