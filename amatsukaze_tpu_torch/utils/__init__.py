"""Run context, batching and device helpers."""

from .context import AMTContext

__all__ = ["AMTContext"]
