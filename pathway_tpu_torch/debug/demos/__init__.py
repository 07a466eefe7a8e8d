"""Self-contained demo pipelines, one per file.

Each module is a runnable program (``python -m
pathway_tpu_torch.debug.demos.word_counts``). The verifier lints them
(``python -m pathway_tpu_torch analyze``), as the reference's lints its
own.
"""

from __future__ import annotations

import os

DEMO_DIR = os.path.dirname(os.path.abspath(__file__))


def demo_programs() -> list[str]:
    """Absolute paths of every runnable demo pipeline in this package."""
    return sorted(
        os.path.join(DEMO_DIR, f)
        for f in os.listdir(DEMO_DIR)
        if f.endswith(".py") and not f.startswith("_")
    )
