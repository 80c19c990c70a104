"""Profiling / tracing hooks, counters, timers and the prover's health
block — port of eigen_zeth_tpu/utils/profiling.py.

`profile_trace` is the JAX package's profiler hook on `torch.profiler`: a
Chrome trace (viewable in Perfetto or chrome://tracing) of the host and,
when a card is present, of its kernels, written into `log_dir`.

Usage:
    with profile_trace("/tmp/ezt-trace") as path:
        prover.gen_chunk_proof(...)
    # path: the trace file, written when the block ends
or set EZT_PROFILE_DIR to trace without naming a directory.  `Metrics`,
`METRICS` and `ProverTelemetry` are copies of the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid


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


class Metrics:
    """Process-local counters/timers (the prometheus-socket analog of the
    reference's --metrics flag, src/commands/reth.rs:48-49)."""

    def __init__(self):
        self.counters: dict[str, int] = {}
        self.timings: dict[str, list[float]] = {}

    def inc(self, name: str, by: int = 1):
        self.counters[name] = self.counters.get(name, 0) + by

    @contextlib.contextmanager
    def timed(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.timings.setdefault(name, []).append(time.time() - t0)

    def report(self) -> dict:
        return {
            "counters": dict(self.counters),
            "timings": {
                k: {"count": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
                for k, v in self.timings.items()
                if v
            },
        }

    def prometheus_text(self, prefix: str = "ezt") -> str:
        """Prometheus exposition format — the /metrics scrape surface (the
        reference gets this from reth's --metrics socket,
        src/commands/reth.rs:48-49)."""
        lines = []
        for name in sorted(self.counters):
            m = f"{prefix}_{name}".replace(".", "_").replace("-", "_")
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {self.counters[name]}")
        for name in sorted(self.timings):
            v = self.timings[name]
            if not v:
                continue
            m = f"{prefix}_{name}".replace(".", "_").replace("-", "_")
            lines.append(f"# TYPE {m}_seconds summary")
            lines.append(f"{m}_seconds_count {len(v)}")
            lines.append(f"{m}_seconds_sum {sum(v):.6f}")
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
        self.metrics = Metrics()

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
