"""Reductions that several metric readers share."""

from __future__ import annotations


def idle_share(record):
    """The device's idle share of the traced slice: one minus the union of
    its activity intervals (kernels, copies, sets) over the slice, percent."""
    t = record.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
