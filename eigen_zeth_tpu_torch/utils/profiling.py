"""Profiling and tracing: the profiler hook, the span tracer, the node's
counters and the prover's health block — port of
eigen_zeth_tpu/utils/profiling.py, with the span tracer the port's own.

`profile_trace` is the JAX package's profiler hook on `torch.profiler`: a
Chrome trace (viewable in Perfetto or chrome://tracing) of the host and,
when a card is present, of its kernels, written into `log_dir`.

Usage:
    with profile_trace("/tmp/ezt-trace") as path:
        prover.gen_chunk_proof(...)
    # path: the trace file, written when the block ends
or set EZT_PROFILE_DIR to trace without naming a directory.

The span tracer records the prover's phases in memory: `span(name,
**attrs)` around a phase, `enable()` to record, `disable()` to stop and take
the spans recorded.  It records while enabled and while a `torch.profiler`
session runs in the process (as torch's `record_function` does), so a
profiled window holds the program's spans without a call; while nothing
records, a span costs two flag tests and returns a shared no-op.  A span's
times are the host's, on `time.time_ns()`, the clock torch.profiler's
events are converted to, so a device gap falls inside the span the host
was in; no span synchronises the card.

`METRICS` counts the node's events for `/metrics`; `ProverTelemetry` is
the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from dataclasses import dataclass, field

from torch.autograd import profiler as _torch_profiler


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """torch.profiler trace around a block, saved as a Chrome trace in
    log_dir (or $EZT_PROFILE_DIR); no trace when neither is given.  Records
    CUDA activity when torch sees a card.  Yields the trace file's path
    (None without a directory); the file is written when the block ends."""
    log_dir = log_dir or os.environ.get("EZT_PROFILE_DIR")
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{uuid.uuid4().hex[:12]}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


_ON = False  # enable() / disable()
_SPANS: list = []  # finished spans, in the order they ended
_OPEN = threading.local()  # .stack: this thread's open spans, innermost last
_OFF = contextlib.nullcontext()  # what `span` returns while nothing records


@dataclass(eq=False)
class Span:
    """One phase on the host: `name`, its interval on `time.time_ns()`,
    the enclosing span (`parent`), the protocol's request id (`request`:
    the task id in step 2, the batch id in steps 1, 3 and 4; a child
    inherits its parent's) and `attrs`."""

    name: str
    start_ns: int = 0
    end_ns: int = 0
    parent: Span | None = field(default=None, repr=False)
    request: str | None = None
    attrs: dict = field(default_factory=dict)

    def __enter__(self) -> Span:
        stack = _stack()
        if stack:
            self.parent = stack[-1]
            if self.request is None:
                self.request = self.parent.request
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        _stack().pop()
        _SPANS.append(self)


class _Read(Span):
    """A blocking device-to-host read: the host waits on the card.  Its
    bytes add to `device_reads` and `read_bytes` of every enclosing span
    that holds them (the prover service's step spans)."""

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        p = self.parent
        while p is not None:
            if "device_reads" in p.attrs:
                p.attrs["device_reads"] += 1
                p.attrs["read_bytes"] += self.attrs["bytes"]
            p = p.parent


def _stack() -> list:
    try:
        return _OPEN.stack
    except AttributeError:
        _OPEN.stack = []
        return _OPEN.stack


def span(name: str, request: str | None = None, **attrs):
    """A context that records the span `name` around its block, or, while
    nothing records, a shared no-op; `as` gives the Span or None."""
    if not (_ON or _torch_profiler._is_profiler_enabled):
        return _OFF
    return Span(name, request=request, attrs=attrs)


def device_read(t):
    """The span "device.read" around a blocking read of tensor `t` to the
    host, with attr `bytes`."""
    if not (_ON or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Read("device.read", attrs={"bytes": t.nbytes})


def enable() -> None:
    """Record spans from here on."""
    global _ON
    _ON = True


def disable() -> list:
    """Stop recording (a running torch.profiler still records); return the
    spans recorded since the last call, in the order they ended, and
    forget them."""
    global _ON, _SPANS
    _ON = False
    out, _SPANS = _SPANS, []
    return out


class Metrics:
    """Process-local counters (the prometheus-socket analog of the
    reference's --metrics flag, src/commands/reth.rs:48-49)."""

    def __init__(self):
        self.counters: dict[str, int] = {}

    def inc(self, name: str, by: int = 1):
        self.counters[name] = self.counters.get(name, 0) + by

    def prometheus_text(self, prefix: str = "ezt") -> str:
        """Prometheus exposition format — the /metrics scrape surface (the
        reference gets this from reth's --metrics socket,
        src/commands/reth.rs:48-49)."""
        lines = []
        for name in sorted(self.counters):
            m = f"{prefix}_{name}".replace(".", "_").replace("-", "_")
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {self.counters[name]}")
        return "\n".join(lines) + "\n"


METRICS = Metrics()


class ProverTelemetry:
    """Fills the protocol's ProverStatus health block
    (proto/prover/v1/prover.proto:176-190: queue ids, computing state,
    cores, memory, fork_id) from live process state.  The reference
    receives these fields from its prover network and logs them
    (src/prover/provider.rs:651-654); here the prover IS in-process, so
    the shim reports real values."""

    def __init__(self, prover_name: str = "ezt-tpu-prover"):
        self.prover_name = prover_name
        self.prover_id = uuid.uuid4().hex[:16]
        self._lock = threading.Lock()
        self.pending: list[str] = []
        self.current_id = ""
        self.current_start = 0
        self.last_id = ""
        self.last_end = 0

    # -- request lifecycle ---------------------------------------------------

    def enqueue(self, request_id: str):
        with self._lock:
            self.pending.append(request_id)

    def start(self, request_id: str):
        with self._lock:
            if request_id in self.pending:
                self.pending.remove(request_id)
            self.current_id = request_id
            self.current_start = int(time.time())

    def finish(self, request_id: str):
        with self._lock:
            self.last_id = request_id
            self.last_end = int(time.time())
            if self.current_id == request_id:
                self.current_id = ""
                self.current_start = 0

    @property
    def computing(self) -> bool:
        return bool(self.current_id)

    # -- host resources ------------------------------------------------------

    @staticmethod
    def memory() -> tuple[int, int]:
        """(total, free) bytes from /proc/meminfo; (0, 0) if unreadable."""
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    parts = line.split()
                    info[parts[0].rstrip(":")] = int(parts[1]) * 1024
            return info.get("MemTotal", 0), info.get("MemAvailable", info.get("MemFree", 0))
        except OSError:
            return 0, 0

    @staticmethod
    def cores() -> int:
        return os.cpu_count() or 1

    def snapshot(self) -> dict:
        """The full ProverStatus field set as a plain dict."""
        total, free = self.memory()
        with self._lock:
            return {
                "last_computed_request_id": self.last_id,
                "last_computed_end_time": self.last_end,
                "current_computing_request_id": self.current_id,
                "current_computing_start_time": self.current_start,
                "pending_request_queue_ids": list(self.pending),
                "prover_name": self.prover_name,
                "prover_id": self.prover_id,
                "number_of_cores": self.cores(),
                "total_memory": total,
                "free_memory": free,
            }
