from . import dtype

__all__ = ["dtype"]
