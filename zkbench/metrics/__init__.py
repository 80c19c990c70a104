"""One reader per metric, named as the metric up to its first dot.  A
reader's `read(rec)` takes the run's `harness.Record` and returns the
metric's value, or None where the run holds nothing to read."""
