"""The serving plane's request deadline (the part of the reference's
``serving/`` that ``rest_connector`` uses without ``serving=``).
Admission control, adaptive batching and the serving metrics come with
ROADMAP Queue A item 3."""

from .deadline import DEADLINE_HEADER, Deadline, DeadlineExceeded

__all__ = ["DEADLINE_HEADER", "Deadline", "DeadlineExceeded"]
