"""Dataset loaders (reference stdlib/ml/datasets)."""

from . import classification

__all__ = ["classification"]
