"""Custom reducer API (reference internals/custom_reducers.py)."""

from ..reducers import BaseCustomAccumulator, stateful_many, stateful_single, udf_reducer

__all__ = [
    "BaseCustomAccumulator",
    "stateful_many",
    "stateful_single",
    "udf_reducer",
]
