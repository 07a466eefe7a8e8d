"""Per-request deadlines for the serving plane.

The port's copy of the reference's ``serving/deadline.py``. A
:class:`Deadline` is an absolute point on the monotonic clock plus the
budget it was created with. It travels with a request from HTTP admission
through batch dispatch to the response wait, so every layer asks the same
object how much time is left. Clients set the budget with the
``X-Pathway-Deadline-Ms`` header; ``Deadline.none()`` means no budget
(``remaining()`` is ``inf``). A handler binds the request's deadline to
its context (``bind_deadline``), so callees on the same thread or task
(retry policies, xpack helpers) read it with ``current_deadline``.
"""

from __future__ import annotations

import contextvars
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


#: the deadline bound to the current context (``bind_deadline``)
_CURRENT: contextvars.ContextVar[Deadline | None] = contextvars.ContextVar("pathway_serving_deadline", default=None)


def current_deadline() -> Deadline | None:
    """The deadline bound to the current context, if any."""
    return _CURRENT.get()


class bind_deadline:
    """``with bind_deadline(d): ...`` scopes a deadline to the current
    context, so :func:`current_deadline` sees it."""

    def __init__(self, deadline: Deadline | None):
        self._deadline = deadline
        self._token = None

    def __enter__(self) -> Deadline | None:
        self._token = _CURRENT.set(self._deadline)
        return self._deadline

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None


def coerce_deadline(value) -> Deadline | None:
    """Accept a :class:`Deadline`, a plain number of *seconds* from now,
    or None — the shapes the retry layer takes."""
    if value is None or isinstance(value, Deadline):
        return value
    return Deadline(float(value) * 1000.0)
