"""The 90th percentile of the request time over every request of the
traced window (Python's statistics.quantiles, inclusive).  Host clock."""

import statistics


def read(rec):
    secs = [(d.end_ns - d.start_ns) / 1e9 for d in rec.requests]
    if len(secs) < 2:
        return None
    return statistics.quantiles(secs, n=10, method="inclusive")[8]
