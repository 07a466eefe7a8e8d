"""Shared model-name constants: the port's copy of the reference's
``xpacks/llm/constants.py``."""

DEFAULT_VISION_MODEL = "gpt-4o"
