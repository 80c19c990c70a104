"""Kernel F's share of its roofline, in percent: the least time the card
could take for the Poseidon2-Fr permutations that the window's requests
commit (zkbench/work_fr.py, from their shapes), over F's device time in the
traced window (the sum of its kernels' durations).

F's kernels are those of csrc/poseidon2_fr*.cu: the perm, hash_rows and
merkle_levels kernels that take no constant block `Consts` (kernel E's of
the same names take it, and E's verifier-rows kernels are E's).  Where no
such kernel ran the reader returns nothing."""

import re

from ..work import Work
from ..work_fr import least_seconds

F_KERNEL = re.compile(r"(perm|hash_rows|merkle_levels)_kernel")


def is_f(name: str) -> bool:
    return bool(F_KERNEL.search(name)) and "Consts" not in name and "verifier" not in name


def read(rec):
    if rec.trace is None:
        return None
    lo, hi = rec.trace.window
    f_ns = sum(min(op.end_ns, hi) - max(op.start_ns, lo) for op in rec.trace.ops
               if op.kind == "kernel" and is_f(op.name) and op.end_ns > lo and op.start_ns < hi)
    if f_ns <= 0:
        return None
    total = Work()
    for d in rec.requests:
        total = total + d.work
    least, _ = least_seconds(total)
    return 100.0 * least / (f_ns / 1e9)
