"""Fault-tolerant runtime: the deterministic fault-injection harness.

The port holds the reference's :mod:`.chaos` whole; its supervisor,
cluster health and retry policy come with ROADMAP Queue A items 6 and 1.
"""

from __future__ import annotations

from . import chaos
from .chaos import ChaosInjected, ChaosPlan

__all__ = ["ChaosInjected", "ChaosPlan", "chaos"]
