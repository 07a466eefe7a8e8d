"""Extension packs: ``llm`` (embedders so far)."""

from . import llm

__all__ = ["llm"]
