from .date_time import DateTimeNamespace
from .numerical import NumericalNamespace
from .string import StringNamespace

__all__ = ["DateTimeNamespace", "NumericalNamespace", "StringNamespace"]
