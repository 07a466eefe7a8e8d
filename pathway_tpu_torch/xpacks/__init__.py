"""Extension packs: ``llm``."""

from . import llm

__all__ = ["llm"]
