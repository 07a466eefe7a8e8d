"""pw.temporal: windows, temporal joins, behaviors.

Rebuild of upstream Pathway's python/pathway/stdlib/temporal/ (_window.py:
_SessionWindow :70, _SlidingWindow :260, windowby :865; asof/interval/
window joins; temporal_behavior.py CommonBehavior :21, ExactlyOnceBehavior
:79; engine side operators/time_column.rs)."""

from ._window import (
    Window,
    session,
    sliding,
    tumbling,
    windowby,
    intervals_over,
)
from ._joins import (
    asof_join,
    asof_join_left,
    asof_join_right,
    asof_join_outer,
    asof_now_join,
    asof_now_join_inner,
    asof_now_join_left,
    interval,
    interval_join,
    interval_join_inner,
    interval_join_left,
    interval_join_right,
    interval_join_outer,
    window_join,
    window_join_inner,
    window_join_left,
    window_join_right,
    window_join_outer,
    Direction,
    Interval,
)

# public names for the join-result types (reference exports these for
# annotations/isinstance; interval and window joins share one result
# implementation here, asof_now returns the core JoinResult)
from ._joins import _AsofJoinResult as AsofJoinResult
from ._joins import _TemporalJoinResult as IntervalJoinResult
from ._joins import _TemporalJoinResult as WindowJoinResult
from ...internals.table import JoinResult as AsofNowJoinResult
from .time_utils import inactivity_detection, utc_now
from .temporal_behavior import (
    Behavior,
    CommonBehavior,
    ExactlyOnceBehavior,
    common_behavior,
    exactly_once_behavior,
)

__all__ = [
    "AsofJoinResult",
    "AsofNowJoinResult",
    "Behavior",
    "CommonBehavior",
    "Direction",
    "ExactlyOnceBehavior",
    "Interval",
    "IntervalJoinResult",
    "Window",
    "WindowJoinResult",
    "inactivity_detection",
    "utc_now",
    "asof_join",
    "asof_join_left",
    "asof_join_outer",
    "asof_join_right",
    "asof_now_join",
    "asof_now_join_inner",
    "asof_now_join_left",
    "common_behavior",
    "exactly_once_behavior",
    "interval",
    "interval_join",
    "interval_join_inner",
    "interval_join_left",
    "interval_join_outer",
    "interval_join_right",
    "intervals_over",
    "session",
    "sliding",
    "tumbling",
    "window_join",
    "window_join_inner",
    "window_join_left",
    "window_join_outer",
    "window_join_right",
    "windowby",
]
