"""The traced run's record: the device's operations from torch.profiler, and
the reduction of them to busy time, idle gaps and time by kernel.

The profiler traces the card only (CUPTI activity): the host's operators
are not recorded, since an attestation launches some 150,000 kernels.  The
events stay in memory and are reduced here; no trace file is written.
Host spans (the harness's requests and the program's stages) are taken on
`time.time_ns()`, the clock the profiler's events are converted to, so a
device gap can be put beside what the host was doing.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field


@dataclass
class DeviceOp:
    name: str
    kind: str  # "kernel", "memcpy", "memset", ...
    start_ns: int
    end_ns: int


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    ops: list = field(default_factory=list)  # DeviceOp, sorted by start
    window: tuple = (0, 0)  # (start_ns, end_ns) of the traced window


class Profiler:
    """torch.profiler over the card alone; `ops()` after `stop()`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def ops(self) -> list:
        from torch.autograd import DeviceType

        out = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            kind = _kind(e)
            if kind is None:
                continue
            start = e.start_ns()
            out.append(DeviceOp(e.name(), kind, start, start + e.duration_ns()))
        out.sort(key=lambda op: op.start_ns)
        return out


def _kind(e) -> str | None:
    """A device op's kind, from its name as CUPTI gives it: copies and
    fills are named "Memcpy ..." and "Memset ...", kernels by their
    function; zero-length markers are no op."""
    if e.duration_ns() <= 0:
        return None
    name = e.name()
    for kind in ("Memcpy", "Memset"):
        if name.startswith(kind):
            return kind.lower()
    return "kernel"


def now_ns() -> int:
    return time.time_ns()


def busy_intervals(ops: list, window: tuple) -> list:
    """The union of the ops' intervals, clipped to the window, sorted."""
    lo, hi = window
    merged = []
    for op in ops:
        s, e = max(op.start_ns, lo), min(op.end_ns, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def busy_seconds(ops: list, window: tuple) -> float:
    return sum(e - s for s, e in busy_intervals(ops, window)) / 1e9


def idle_gaps(ops: list, window: tuple) -> list:
    """(start_ns, end_ns) of every interval of the window with no op."""
    gaps, cur = [], window[0]
    for s, e in busy_intervals(ops, window):
        if s > cur:
            gaps.append((cur, s))
        cur = e
    if window[1] > cur:
        gaps.append((cur, window[1]))
    return gaps


def time_by_name(ops: list, window: tuple) -> dict:
    """Seconds of device time per op name inside the window."""
    lo, hi = window
    out: dict = {}
    for op in ops:
        s, e = max(op.start_ns, lo), min(op.end_ns, hi)
        if e > s:
            out[op.name] = out.get(op.name, 0.0) + (e - s) / 1e9
    return out


def idle_by_span(ops: list, window: tuple, spans: list) -> dict:
    """Idle seconds of the window by the innermost host span that holds
    them (the latest-starting span that covers the instant); time outside
    every span is "between requests"."""
    # an outer span before the inner ones that start with it
    spans = sorted(spans, key=lambda sp: (sp.start_ns, -sp.end_ns))
    starts = [sp.start_ns for sp in spans]
    out: dict = {}
    for gs, ge in idle_gaps(ops, window):
        cur = gs
        while cur < ge:
            # the innermost span covering `cur`, and where that stops holding
            i = bisect.bisect_right(starts, cur) - 1
            name, stop = "between requests", ge
            while i >= 0:
                sp = spans[i]
                if sp.end_ns > cur:
                    name, stop = sp.name, min(ge, sp.end_ns)
                    break
                i -= 1
            nxt = bisect.bisect_right(starts, cur)
            if nxt < len(starts) and starts[nxt] < stop:
                stop = starts[nxt]
            out[name] = out.get(name, 0.0) + (stop - cur) / 1e9
            cur = stop
    return out


def top(d: dict, k: int = 10) -> list:
    return [[name, secs] for name, secs in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
