"""The device's idle share of the traced slice, percent (``readers.idle_share``)."""

from benchmark.readers import idle_share as read  # noqa: F401
