"""One run of one cell: set-up, the measured window, the traced window's
reduction, the check against the plain reference, and the result line.

A cell is an entry of BENCHMARK.json's `workloads`; everything it names is
found by name:
  BENCHMARK.json `configs`   the configuration's file (zkbench/configs/)
  zkbench/traffic/<traffic>.json  the traffic mix, read by zkbench/traffic.py
  zkbench/entries/<entry>.py      the driver of the entry the window calls
  zkbench/metrics/<metric>.py     one reader per metric (the name up to its
                                  first dot), for every end-to-end and
                                  per-layer metric that lists the cell
A reader takes the run's `Record` and returns a number or None; a metric
whose reader finds nothing to read is left out of the line.

The window is a closed loop with one request in flight: a request starts
only while the time since the window opened is under --seconds, and the
window closes when the last one started has completed, so it holds whole
requests only; their answers are read and hashed after it.  Every request's inputs come from (seed, its index) through
zkbench/traffic.py and are made in set-up, the pool sized from the last
warm-up request's time (half of it a request); a pool used up closes the
window early and says so on standard error.
"""

from __future__ import annotations

import gc
import hashlib
import importlib
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import trace as trace_m
from . import traffic as traffic_m
from .work import Work

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "eigen_zeth_tpu")


@dataclass
class Done:
    """One request of the window."""

    index: int
    start_ns: int
    end_ns: int
    units: int
    ok: bool
    digests: list  # sha256 of each answer, in order
    work: Work
    error: str = ""


@dataclass
class Record:
    """What a run measured, for the metric readers."""

    setup_s: float
    window: tuple  # (start_ns, end_ns)
    requests: list  # Done
    spans: list = field(default_factory=list)  # trace.Span, traced runs only
    trace: trace_m.Trace | None = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def digest(answer: str) -> str:
    return hashlib.sha256(answer.encode()).hexdigest()


def load_cell(name: str) -> dict:
    """The cell `name` of BENCHMARK.json with its configuration, traffic and
    the names of the metrics that list it."""
    with open(CHECKOUT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"zkbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(CHECKOUT / conf["file"]) as f:
        config = json.load(f)

    def listed(metrics):
        return [m["name"] for m in metrics if name in m.get("workloads", [name])]

    return {
        "name": name,
        "chips": cell["chips"],
        "config": config,
        "traffic": traffic_m.load(ROOT, cell["traffic"]),
        "end_to_end": listed(bench["end_to_end"]),
        "per_layer": listed(bench["per_layer"]),
        "units": {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]},
    }


def make_prover(config: dict, device):
    """The system under test: the port's BatchProver as the configuration
    states it."""
    from eigen_zeth_tpu_torch.models import stark
    from eigen_zeth_tpu_torch.protocol import prover_service as ps

    kw = dict(config["prover"])
    params = stark.StarkParams(**kw.pop("stark_params"))
    prover = ps.BatchProver(stark_params=params, device=device, **kw)
    if prover.chunk_elems != config["chunk_elems"]:
        raise ValueError(f"the prover packs {prover.chunk_elems} elements a chunk, "
                         f"the configuration states {config['chunk_elems']}")
    return prover


def driver_for(cell: dict, prover, device):
    mod = importlib.import_module(f"zkbench.entries.{cell['traffic']['entry']}")
    return mod.Driver(prover, cell["config"], cell["traffic"], device)


def reader(metric: str):
    return importlib.import_module(f"zkbench.metrics.{metric.split('.')[0]}")


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device, *,
             t_start: float, prover=None, log=print) -> dict:
    """One run of `cell`; returns the result line's object.  `prover`
    replaces the system under test (the control)."""
    import torch

    seed %= 1 << 64
    config, traffic = cell["config"], cell["traffic"]
    if prover is None:
        prover = make_prover(config, device)
    drv = driver_for(cell, prover, device)

    # set-up: warm-up requests, then the pool of inputs for the window
    warm_s, failed_warm = 0.0, []
    for i in range(traffic["warmup"]):
        req = traffic_m.request(seed, i, traffic, config)
        prepared = drv.prepare(req)
        _sync(device)
        t = time.perf_counter()
        ok, answers, error = drv.answers(drv.call(prepared))
        _sync(device)
        warm_s = time.perf_counter() - t
        if not ok:
            failed_warm.append(f"warm-up request {i}: {error}")
    n_pool = math.ceil(seconds / max(0.5 * warm_s, 1e-3)) + 1
    first = traffic["warmup"]
    reqs = [traffic_m.request(seed, first + i, traffic, config) for i in range(n_pool)]
    pool = [(req, drv.prepare(req)) for req in reqs]
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"zkbench: set-up {setup_s:.3f} s (the last warm-up request {warm_s:.3f} s); "
        f"a pool of {n_pool} inputs")

    spans: list = []
    prof = trace_m.Profiler() if traced else None
    if traced:
        drv.spans = spans
        prof.start()
    timed = []  # (request, start, end, output): the answers are read after the window
    _sync(device)
    host0 = host_sample()
    w0 = trace_m.now_ns()
    limit = w0 + int(seconds * 1e9)
    for req, prepared in pool:
        if trace_m.now_ns() >= limit:
            break
        s = trace_m.now_ns()
        out = drv.call(prepared)
        _sync(device)
        timed.append((req, s, trace_m.now_ns(), out))
    else:
        if pool and trace_m.now_ns() < limit:
            log(f"zkbench: the pool of {len(pool)} inputs ran out "
                f"{(limit - trace_m.now_ns()) / 1e9:.3f} s before the window's end")
    host1 = host_sample()
    if traced:
        prof.stop()
        drv.spans = None
    done = []
    for req, s, e, out in timed:
        ok, answers, error = drv.answers(out)
        done.append(Done(req.index, s, e, drv.units(), ok, [digest(a) for a in answers],
                         drv.work(), error))
        if traced:
            spans.append(trace_m.Span("request", s, e))
    del timed
    w1 = done[-1].end_ns if done else trace_m.now_ns()
    log("zkbench: the host over the window: " + host_delta(host0, host1))
    tr = None
    if traced:
        t = time.perf_counter()
        tr = trace_m.Trace(ops=prof.ops(), window=(w0, w1))
        del prof
        log(f"zkbench: {len(tr.ops)} device ops read from the profiler in "
            f"{time.perf_counter() - t:.3f} s")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec = Record(setup_s=setup_s, window=(w0, w1), requests=done,
                 spans=spans, trace=tr)

    metrics = {}
    for name in cell["per_layer"] if traced else cell["end_to_end"]:
        value = reader(name).read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": cell["units"][name]}

    result = {
        "correct": False,
        "attempted": len(done),
        "failed": sum(not d.ok for d in done),
        "metrics": metrics,
        "device": device_info(device, peak),
    }
    if tr is not None:
        busy = trace_m.busy_seconds(tr.ops, tr.window)
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = rec.window_s
        result["breakdown"] = {
            "device_ops": trace_m.top(trace_m.time_by_name(tr.ops, tr.window)),
            "idle_gaps": trace_m.top(trace_m.idle_by_span(tr.ops, tr.window, spans)),
        }

    # the check: the program's state freed, then the reference on a sample
    del reqs, pool, drv, prover, rec, tr
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check(cell, seed, done, device, failed_warm, log)
    log(f"zkbench: window {(w1 - w0) / 1e9:.3f} s, {len(done)} requests; "
        f"the reference's check {time.perf_counter() - t:.3f} s")
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def check(cell: dict, seed: int, done: list, device, failed_warm: list, log) -> dict:
    """The compared numbers, each with its limit: requests that failed
    (warm-up included), and answers of the sampled requests that differ
    from the reference's, byte for byte (missing ones counted)."""
    config, traffic = cell["config"], cell["traffic"]
    mod = importlib.import_module(f"zkbench.entries.{traffic['entry']}")
    for msg in failed_warm:
        log(f"zkbench: {msg}")
    for d in done:
        if not d.ok:
            log(f"zkbench: request {d.index} failed: {d.error}")
    differing = 0
    positions = traffic_m.sample(seed, len(done), traffic["check"])
    for pos in positions:
        d = done[pos]
        n, worked = compare(mod, seed, d.index, d.digests, traffic, config, device)
        if n:
            log(f"zkbench: request {d.index}: {n} of the {worked} answers worked out differ "
                "from the reference's")
        differing += n
    return {
        "requests_failed": {"value": len(failed_warm) + sum(not d.ok for d in done), "limit": 0},
        "nothing_checked": {"value": 0 if positions else 1, "limit": 0},
        "answers_differing": {"value": differing, "limit": 0},
    }


def compare(mod, seed: int, index: int, digests: list, traffic: dict, config: dict,
            device) -> tuple:
    """(answers that differ, answers worked out) for request `index` of a
    run with `seed` whose answers' sha256 are `digests`: the reference
    works out the answers that the entry's `pick` draws from the seed (all
    where it has none); a missing or extra answer differs."""
    req = traffic_m.request(seed, index, traffic, config)
    pick = getattr(mod, "pick", None)
    want = [None if a is None else digest(a)
            for a in mod.expected(req, config, device, pick(seed, index) if pick else None)]
    n = sum(a != b for a, b in zip(digests, want) if b is not None)
    return n + abs(len(digests) - len(want)), sum(b is not None for b in want)


def host_sample() -> dict:
    """This process's CPU seconds and torch's intra-op threads, read at one
    moment.  The machine's own load, stolen time and clock are left out: the
    card's host answers them with constants."""
    import resource

    import torch

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu_s": ru.ru_utime + ru.ru_stime,
            "threads": torch.get_num_threads()}


def host_delta(a: dict, b: dict) -> str:
    """One line on the host over a stretch between two samples."""
    return (f"process CPU {b['cpu_s'] - a['cpu_s']:.3f} s of {b['t'] - a['t']:.3f} s; "
            f"torch threads {b['threads']}")


def device_info(device, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
