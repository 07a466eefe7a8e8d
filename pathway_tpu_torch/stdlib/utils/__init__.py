from . import bucketing, col, filtering
from .async_transformer import AsyncTransformer
from .col import unpack_col
from .filtering import argmax_rows, argmin_rows
from .pandas_transformer import pandas_transformer

__all__ = [
    "AsyncTransformer",
    "argmax_rows",
    "argmin_rows",
    "bucketing",
    "col",
    "filtering",
    "pandas_transformer",
    "unpack_col",
]
