"""Kernel E's share of its roofline, in percent: the least time the card
could take for the Poseidon2-Goldilocks permutations that the window's
requests need (zkbench/work.py, from their shapes), over E's device time
in the traced window (the sum of its kernels' durations).

E's kernels are those of csrc/poseidon2_gl.cu: the perm, hash_rows,
hash_two and merkle_levels kernels, whose last argument is E's constant
block `Consts` (kernel F's kernels of the same names take none).  Where
no such kernel ran the reader returns nothing."""

import re

from ..work import Work, least_seconds

E_KERNEL = re.compile(r"(perm|hash_rows|hash_two|merkle_levels)_kernel")


def is_e(name: str) -> bool:
    return bool(E_KERNEL.search(name)) and "Consts" in name


def read(rec):
    if rec.trace is None:
        return None
    lo, hi = rec.trace.window
    e_ns = sum(min(op.end_ns, hi) - max(op.start_ns, lo) for op in rec.trace.ops
               if op.kind == "kernel" and is_e(op.name) and op.end_ns > lo and op.start_ns < hi)
    if e_ns <= 0:
        return None
    total = Work()
    for d in rec.requests:
        total = total + d.work
    least, _ = least_seconds(total)
    return 100.0 * least / (e_ns / 1e9)
