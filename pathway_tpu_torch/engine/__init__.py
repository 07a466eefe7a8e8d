"""Engine: the incremental dataflow runtime.

A replacement for the reference's Rust engine + PyO3 bridge
(upstream Pathway's src/engine/, src/python_api.rs)."""

from . import dataflow, reducers, value
from .dataflow import EngineGraph, EngineError, InputSession
from .value import ERROR, Json, Pointer, PyObjectWrapper, ref_scalar, unsafe_make_pointer

__all__ = [
    "EngineGraph",
    "EngineError",
    "ERROR",
    "InputSession",
    "Json",
    "Pointer",
    "PyObjectWrapper",
    "dataflow",
    "reducers",
    "ref_scalar",
    "unsafe_make_pointer",
    "value",
]
