#!/usr/bin/env python3
"""The span tracer's cost on the card: a benchmark cell's requests timed
with the program's tracer (`utils/profiling.py`) on and off, the profiler
off, on the same inputs.

    python3 scripts/tracer_cost.py --workload chunks.stark-wrap-2leaf.block-30m \
        [--seeds 6] [--requests 10] [--seed 2147510001] [--out chiprun_out/cost.json]

Builds the cell's prover and driver as the benchmark does, runs the
traffic's warm-up requests, then for each of `--seeds` seeds prepares
`--requests` requests of that seed and times the loop over them twice, the
tracer off and on, in alternating order from seed to seed, each request
synchronised.  Prints, per loop and over all, the mean request time, the
spans recorded a request, and whether the traced answers equal the
untraced ones byte for byte; and the host's nanoseconds for one span's
enter and exit, the tracer off and on, over 10^5 spans.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from zkbench import run as zrun  # noqa: E402,F401  (the run's environment: caches, one thread)
from zkbench import harness  # noqa: E402
from zkbench import traffic as traffic_m  # noqa: E402


def loop(drv, prepared: list, traced: bool, device) -> tuple:
    """(mean seconds a request, spans recorded, answers) of one loop."""
    import torch

    from eigen_zeth_tpu_torch.utils import profiling

    profiling.disable()
    if traced:
        profiling.enable()
    secs, answers = [], []
    for p in prepared:
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = drv.call(p)
        torch.cuda.synchronize(device)
        secs.append(time.perf_counter() - t)
        ok, got, error = drv.answers(out)
        if not ok:
            raise RuntimeError(error)
        answers.append(got)
    spans = profiling.disable()
    return statistics.fmean(secs), len(spans), answers


def span_ns(n: int = 100_000) -> dict:
    """Host nanoseconds of one span's enter and exit, the tracer off and on."""
    from eigen_zeth_tpu_torch.utils import profiling

    out = {}
    for traced in (False, True):
        profiling.disable()
        if traced:
            profiling.enable()
        t = time.perf_counter_ns()
        for i in range(n):
            with profiling.span("fri.layer", layer=i):
                pass
        out["on" if traced else "off"] = (time.perf_counter_ns() - t) / n
        profiling.disable()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2147510001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tracer_cost: this measurement needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    config, traffic = cell["config"], cell["traffic"]
    drv = harness.driver_for(cell, harness.make_prover(config, device), device)
    for i in range(traffic["warmup"]):
        drv.answers(drv.call(drv.prepare(traffic_m.request(args.seed, i, traffic, config))))

    runs = []
    for k in range(args.seeds):
        seed = args.seed + k
        prepared = [drv.prepare(traffic_m.request(seed, i, traffic, config))
                    for i in range(args.requests)]
        got = {}
        for traced in ((False, True) if k % 2 == 0 else (True, False)):
            got[traced] = loop(drv, prepared, traced, device)
        runs.append({"seed": seed, "off_s": got[False][0], "on_s": got[True][0],
                     "spans_a_request": got[True][1] / args.requests,
                     "identical": got[False][2] == got[True][2]})
        print(json.dumps(runs[-1]), flush=True)
    off = [r["off_s"] for r in runs]
    on = [r["on_s"] for r in runs]
    out = {"workload": args.workload, "card": card, "requests_a_loop": args.requests,
           "runs": runs, "off_mean_s": statistics.fmean(off), "on_mean_s": statistics.fmean(on),
           "on_over_off": statistics.fmean(on) / statistics.fmean(off),
           "identical": all(r["identical"] for r in runs), "span_ns": span_ns()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0 if out["identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
