"""Shared exception types."""


class CorruptStreamError(ValueError):
    """A compressed stream is truncated or internally inconsistent."""
