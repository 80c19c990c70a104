"""Device kernels in the traced window over the chunk proofs completed in
it (profiler's device trace)."""


def read(rec):
    if rec.trace is None:
        return None
    lo, hi = rec.trace.window
    n = sum(1 for op in rec.trace.ops if op.kind == "kernel" and lo <= op.start_ns < hi)
    units = sum(d.units for d in rec.requests if d.ok)
    return n / units if units and n else None
