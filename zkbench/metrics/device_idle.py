"""Percent of the traced window in which no operation runs on the card:
one less the union of the device ops' intervals over the window."""

from ..trace import busy_seconds


def read(rec):
    if rec.trace is None or rec.window_s <= 0 or not rec.trace.ops:
        return None
    return 100.0 * (1.0 - busy_seconds(rec.trace.ops, rec.trace.window) / rec.window_s)
