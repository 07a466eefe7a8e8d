"""Wall-clock helpers: a ticking UTC-time table and stream-silence
alerting built on it.

Behavioral parity with the reference's stdlib/temporal/time_utils.py
(utc_now :31, inactivity_detection :52), reimplemented on this
framework's connector + asof_now machinery.
"""

from __future__ import annotations

import datetime
import time as _time

from ... import io
from ... import reducers
from ...internals import schema as _schema
from ...internals import table as _table
from ...internals.expression import ColumnReference
from ...internals.thisclass import this

_now_tables: dict[tuple, _table.Table] = {}


def utc_now(refresh_rate: datetime.timedelta = datetime.timedelta(seconds=60)):
    """A single-column streaming table (``timestamp_utc``) that re-emits
    the current UTC wall-clock time every ``refresh_rate``.

    Calls with the same refresh rate share one ticking source per parse
    graph — joining several pipelines against "now" costs one clock
    thread, not one per call site.
    """
    from ...internals.parse_graph import G

    # keyed by graph GENERATION: clear_graph() bumps it, so a new
    # program gets a fresh clock and stale entries are dropped
    cache_key = (G.generation, refresh_rate)
    cached = _now_tables.get(cache_key)
    if cached is not None:
        return cached
    for k in [k for k in _now_tables if k[0] != G.generation]:
        del _now_tables[k]

    Clock = _schema.schema_from_types(timestamp_utc=datetime.datetime)

    class _Tick(io.python.ConnectorSubject):
        def run(self) -> None:
            import os

            period = refresh_rate.total_seconds()
            # tests bound the otherwise-endless clock so pw.run() can
            # terminate on its own
            max_ticks = int(os.environ.get("PATHWAY_TPU_CLOCK_MAX_TICKS", "0"))
            n = 0
            while True:
                self.next(
                    timestamp_utc=datetime.datetime.now(datetime.timezone.utc)
                )
                self.commit()
                n += 1
                if max_ticks and n >= max_ticks:
                    return
                _time.sleep(period)

    out = io.python.read(_Tick(), schema=Clock)
    _now_tables[cache_key] = out
    return out


def inactivity_detection(
    event_time_column: ColumnReference,
    allowed_inactivity_period: datetime.timedelta,
    refresh_rate: datetime.timedelta = datetime.timedelta(seconds=1),
    instance: ColumnReference | None = None,
) -> tuple[_table.Table, _table.Table]:
    """Flag gaps in a stream: whenever no event (per ``instance``) lands
    within ``allowed_inactivity_period`` of the previous one, emit the
    last-seen timestamp; when events start again, emit the first one.

    Assumes ``event_time_column`` carries current UTC timestamps and
    ingest latency is small against the allowed gap (same contract as
    the reference). Returns ``(inactivities, resumed_activities)``:
    ``inactivities.inactive_t`` is the last event time before each
    detected gap, ``resumed_activities.resumed_t`` the first event time
    after it; each carries ``instance`` when one was given.
    """
    events = event_time_column.table.select(
        t=event_time_column, instance=instance
    )
    clock = utc_now(refresh_rate=refresh_rate)

    # newest event per instance — guarded against historical backfill
    # (a freshly started pipeline replaying old data must not page
    # anyone about "inactivity" that predates the monitor)
    newest = (
        events.groupby(this.instance)
        .reduce(this.instance, latest_t=reducers.max(this.t))
        .filter(this.latest_t > datetime.datetime.now(datetime.timezone.utc))
    )

    # each clock tick checks the newest event as-of that moment; ticks
    # are frozen once answered, so a late event cannot retract an alert
    gap_checks = clock.asof_now_join(newest).select(
        now=this.timestamp_utc,  # pw.left
        instance=newest.instance,
        latest_t=newest.latest_t,
    )
    inactivities = (
        gap_checks.filter(this.latest_t + allowed_inactivity_period < this.now)
        .groupby(this.latest_t, this.instance)
        .reduce(this.latest_t, this.instance)
        .select(instance=this.instance, inactive_t=this.latest_t)
    )

    # first event after the most recent alert, per instance
    newest_alert = inactivities.groupby(this.instance).reduce(
        this.instance, inactive_t=reducers.latest(this.inactive_t)
    )
    resumed = (
        events.asof_now_join(
            newest_alert, events.instance == newest_alert.instance
        )
        .select(
            t=events.t, instance=events.instance, inactive_t=newest_alert.inactive_t
        )
        # keyed per alert: every inactivity gap gets its own first
        # post-gap event, not just the first-ever resumption
        .groupby(this.inactive_t, this.instance)
        .reduce(this.instance, resumed_t=reducers.min(this.t))
    )
    if instance is None:
        inactivities = inactivities.without(this.instance)
        resumed = resumed.without(this.instance)
    return inactivities, resumed
