"""Per-request deadlines for the serving plane.

The port's copy of the reference's ``serving/deadline.py``. A
:class:`Deadline` is an absolute point on the monotonic clock plus the
budget it was created with. It travels with a request from HTTP admission
through batch dispatch to the response wait, so every layer asks the same
object how much time is left. Clients set the budget with the
``X-Pathway-Deadline-Ms`` header; ``Deadline.none()`` means no budget
(``remaining()`` is ``inf``).
"""

from __future__ import annotations

import math
import time as _time

#: HTTP request header carrying the client's total budget in milliseconds
DEADLINE_HEADER = "X-Pathway-Deadline-Ms"


class Deadline:
    """Remaining-time budget anchored to the monotonic clock.

    ``budget_ms=None`` builds an infinite deadline: ``remaining()``
    returns ``inf`` and ``expired()`` is always False. ``start=`` (a
    ``time.monotonic()`` value) is injectable for tests.
    """

    __slots__ = ("budget_ms", "start")

    def __init__(self, budget_ms: float | None, *, start: float | None = None):
        if budget_ms is not None:
            budget_ms = max(0.0, float(budget_ms))
        self.budget_ms = budget_ms
        self.start = _time.monotonic() if start is None else start

    @classmethod
    def none(cls) -> "Deadline":
        return cls(None)

    @classmethod
    def from_header(cls, header_value: str | None, default_ms: float | None = None) -> "Deadline":
        """The request deadline from the raw header value, falling back to
        the server default. An unparsable header counts as absent (the
        request is served, not rejected, on a bad header)."""
        if header_value is not None:
            try:
                return cls(float(header_value))
            except (TypeError, ValueError):
                pass
        return cls(default_ms)

    @property
    def expires_at(self) -> float:
        """Monotonic-clock expiry; ``inf`` for an unbounded deadline. The
        admission queue and the batcher order requests by this."""
        if self.budget_ms is None:
            return math.inf
        return self.start + self.budget_ms / 1000.0

    def remaining(self) -> float:
        """Seconds left; ``inf`` when unbounded, floored at 0.0."""
        if self.budget_ms is None:
            return math.inf
        return max(0.0, self.expires_at - _time.monotonic())

    def remaining_ms(self) -> float:
        rem = self.remaining()
        return rem if math.isinf(rem) else rem * 1000.0
