"""Temporal behaviors (reference stdlib/temporal/temporal_behavior.py:
CommonBehavior :21, ExactlyOnceBehavior :79). Compile to engine
buffer/forget/freeze (operators/time_column.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


class Behavior:
    pass


@dataclass
class CommonBehavior(Behavior):
    """delay: hold window results until watermark >= window_start + delay;
    cutoff: ignore late data & forget state once watermark >= window_end +
    cutoff; keep_results: whether forgotten windows' outputs stay."""

    delay: Any = None
    cutoff: Any = None
    keep_results: bool = True


def common_behavior(delay=None, cutoff=None, keep_results: bool = True) -> CommonBehavior:
    return CommonBehavior(delay, cutoff, keep_results)


@dataclass
class ExactlyOnceBehavior(Behavior):
    """Each window emitted exactly once, when its end (+shift) passes."""

    shift: Any = None


def exactly_once_behavior(shift=None) -> ExactlyOnceBehavior:
    return ExactlyOnceBehavior(shift)
