"""Extension packs: ``connectors`` and ``llm``."""

from . import connectors, llm

__all__ = ["connectors", "llm"]
