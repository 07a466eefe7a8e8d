"""Retry scheduling and resilient request execution for the HTTP client
connectors.

The port's copy of the reference's ``io/http/_retry.py`` (upstream
Pathway's python/pathway/io/http/_common.py: RetryPolicy :13, Sender :38).
The request loop tells transport errors from retryable status codes, takes
an injectable session and sleep function (tests drive it without real
endpoints or real delays) and keeps the backoffs it took.

``RetryPolicy`` and ``DEFAULT_RETRY_CODES`` are the shared definitions of
:mod:`pathway_tpu_torch.resilience`, re-exported here as the reference
does, so the HTTP connectors and the rest of the runtime cannot drift
apart.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from ...resilience.retry import DEFAULT_RETRY_CODES, RetryPolicy

__all__ = ["DEFAULT_RETRY_CODES", "RetryPolicy", "RequestRunner"]


class RequestRunner:
    """Executes one logical HTTP request with bounded retries.

    A fresh :class:`RetryPolicy` is built per logical request (through
    ``retry_policy_factory``), so the backoff schedule restarts for every
    new request rather than escalating over the connector's lifetime.
    """

    def __init__(
        self,
        session: Any,
        *,
        n_retries: int = 0,
        retry_policy_factory: Callable[[], RetryPolicy] | None = None,
        retry_codes: tuple[int, ...] | None = DEFAULT_RETRY_CODES,
        connect_timeout_ms: int | None = None,
        request_timeout_ms: int | None = None,
        allow_redirects: bool = True,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self._session = session
        self._n_retries = n_retries
        self._policy_factory = retry_policy_factory or RetryPolicy.default
        self._retry_codes = tuple(retry_codes or ())
        self._timeout = (
            connect_timeout_ms / 1000.0 if connect_timeout_ms else None,
            request_timeout_ms / 1000.0 if request_timeout_ms else None,
        )
        self._allow_redirects = allow_redirects
        self._sleep = sleep
        #: (attempt_index, wait_seconds) per backoff taken, for tests and metrics
        self.backoffs: list[tuple[int, float]] = []

    def send(
        self,
        method: str,
        url: str,
        *,
        headers: dict[str, str] | None = None,
        data: Any = None,
        stream: bool = False,
        deadline: Any = None,
    ):
        """``deadline=`` (a ``pathway_tpu_torch.serving.Deadline`` or float
        seconds) stops the retry loop early: a backoff that would sleep past
        the remaining budget is skipped and the last response or exception
        surfaces at once."""
        from ...serving.deadline import coerce_deadline

        deadline = coerce_deadline(deadline)
        policy = self._policy_factory()
        last_exc: Exception | None = None
        response = None
        for attempt in range(self._n_retries + 1):
            try:
                response = self._session.request(
                    method,
                    url,
                    headers=headers,
                    data=data,
                    stream=stream,
                    timeout=self._timeout,
                    allow_redirects=self._allow_redirects,
                )
                last_exc = None
            except Exception as exc:  # noqa: BLE001 - any transport failure is retried, the last one raised
                last_exc = exc
                response = None
            if response is not None:
                status = getattr(response, "status_code", 200)
                if status < 400 or status not in self._retry_codes:
                    return response
            if attempt == self._n_retries:
                break
            wait = policy.wait_duration_before_retry()
            if deadline is not None and wait >= deadline.remaining():
                break
            self.backoffs.append((attempt, wait))
            self._sleep(wait)
        if last_exc is not None:
            raise last_exc
        if response is None:
            raise RuntimeError(f"{method} {url}: no response and no error")
        return response
