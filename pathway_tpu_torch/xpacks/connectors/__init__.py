"""Enterprise xpack connectors (the port's copy of the reference's
``xpacks/connectors``)."""

from . import sharepoint

__all__ = ["sharepoint"]
