"""The serving plane of the port: per-request deadlines, admission control
and load shedding, adaptive batching and the serving metrics (the
reference's ``serving/``). ``DecodeService`` fronts the decode engine with
the ``AdaptiveBatcher``; ``rest_connector(serving=)`` puts a REST endpoint
behind admission and batching."""

from .admission import (
    AdmissionController,
    DeadlineExceeded,
    OverloadError,
    QueueFull,
    RateLimited,
    ServingConfig,
    ShardUnavailable,
    TenantRateLimited,
    Ticket,
    TokenBucket,
)
from .batching import AdaptiveBatcher
from .deadline import DEADLINE_HEADER, Deadline, bind_deadline, coerce_deadline, current_deadline
from .metrics import SERVING_METRICS, ServingMetrics

__all__ = [
    "AdaptiveBatcher",
    "AdmissionController",
    "DEADLINE_HEADER",
    "Deadline",
    "DeadlineExceeded",
    "OverloadError",
    "QueueFull",
    "RateLimited",
    "SERVING_METRICS",
    "ServingConfig",
    "ServingMetrics",
    "ShardUnavailable",
    "TenantRateLimited",
    "Ticket",
    "TokenBucket",
    "bind_deadline",
    "coerce_deadline",
    "current_deadline",
]
