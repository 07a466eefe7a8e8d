"""Self-contained demo pipelines, one per file.

Each module is a runnable program (``python -m
pathway_tpu_torch.debug.demos.word_counts``). The reference's static
verifier lints the same programs (``cli analyze``); the port's comes with
ROADMAP Queue A item 10, and its ``analyze`` raises until then.
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
