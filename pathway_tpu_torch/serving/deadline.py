"""Per-request deadlines.

The port's copy of the part of the reference's ``serving/deadline.py``
and ``serving/admission.py`` that ``rest_connector`` uses without the
serving plane: a :class:`Deadline` is an absolute point on the monotonic
clock plus the budget it was created with, parsed from the client's
``X-Pathway-Deadline-Ms`` header; the response wait is bounded by what
is left of it, and expiry answers a typed 503 (:class:`DeadlineExceeded`).
"""

from __future__ import annotations

import math
import time as _time

#: HTTP request header carrying the client's total budget in milliseconds
DEADLINE_HEADER = "X-Pathway-Deadline-Ms"


class Deadline:
    """Remaining-time budget anchored to the monotonic clock.

    ``budget_ms=None`` builds an infinite deadline: ``remaining()``
    returns ``inf``. ``start=`` (a ``time.monotonic()`` value) is
    injectable for tests.
    """

    __slots__ = ("budget_ms", "start")

    def __init__(self, budget_ms: float | None, *, start: float | None = None):
        if budget_ms is not None:
            budget_ms = max(0.0, float(budget_ms))
        self.budget_ms = budget_ms
        self.start = _time.monotonic() if start is None else start

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
        """Monotonic-clock expiry; ``inf`` for an unbounded deadline."""
        if self.budget_ms is None:
            return math.inf
        return self.start + self.budget_ms / 1000.0

    def remaining(self) -> float:
        """Seconds left; ``inf`` when unbounded, floored at 0.0."""
        if self.budget_ms is None:
            return math.inf
        return max(0.0, self.expires_at - _time.monotonic())


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before the pipeline answered: a typed
    503 whose body names the reason (the reference's
    ``serving/admission.py`` rejection)."""

    status = 503
    reason = "deadline_exceeded"

    def to_response(self) -> dict:
        return {"error": str(self), "reason": self.reason}
