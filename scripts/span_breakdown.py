#!/usr/bin/env python3
"""One traced run of a benchmark cell, and where its time went by the
program's spans.

    python3 scripts/span_breakdown.py --workload chunks.stark-wrap-2leaf.block-30m \
        --seed 2147500001 [--seconds 51] [--out chiprun_out/spans.json]

Runs the cell as `zkbench/run.py --trace 1` does (the same harness: set-up,
the traced window, the check) and prints its result line.  Then, from the
run's record (the harness's request spans, the stage hook's, the program's
own spans and the card's operations), a summary, on standard output and as
JSON in `--out`:

  idle      the card's idle seconds by the innermost span holding them,
            every name (the result line keeps the top ten), and the shares
            under the program's spans, under "request" and between requests
  spans     per program span name: count, seconds a request, idle seconds
            inside its intervals and device-busy seconds (its length less
            those), each a request
  self      of each step span ("step2", "step3"), its self time a request
            (the part no child span covers), by the child it follows

Needs a CUDA device, as the cell does.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from zkbench import run as zrun  # noqa: E402  (the run's environment: caches, one thread)
from zkbench import harness, trace  # noqa: E402
from zkbench.metrics import _program  # noqa: E402


def traced_run(cell: dict, seed: int, seconds: float, device, t_start: float, log) -> tuple:
    """(result line, record) of one traced run of `cell`: the harness's run,
    its record kept from the first reader that reads it."""
    kept = []
    reader = harness.reader

    def keeping(name):
        mod = reader(name)

        class Keep:
            @staticmethod
            def read(rec):
                if not kept:
                    kept.append(rec)
                return mod.read(rec)

        return Keep

    harness.reader = keeping
    try:
        result = harness.run_cell(cell, seed, seconds, True, device, t_start=t_start, log=log)
    finally:
        harness.reader = reader
    return result, kept[0]


def overlap(gaps: list, starts: list, prefix: list, s: int, e: int) -> int:
    """Nanoseconds of the sorted, disjoint `gaps` inside [s, e]."""
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    j = bisect.bisect_left(starts, e)
    if i >= j:
        return 0
    total = prefix[j] - prefix[i]
    total -= max(0, min(gaps[i][1], s) - gaps[i][0])  # the part of the first gap before s
    total -= max(0, gaps[j - 1][1] - max(gaps[j - 1][0], e))  # the part of the last after e
    return max(total, 0)


def summary(rec) -> dict:
    program = _program.spans(rec)
    n_req = max(len(rec.requests), 1)
    ops, window = rec.trace.ops, rec.trace.window
    idle = trace.idle_by_span(ops, window, rec.spans)
    total_idle = sum(idle.values())
    names = {s.name for s in program}
    gaps = trace.idle_gaps(ops, window)
    starts = [g[0] for g in gaps]
    prefix = [0]
    for g in gaps:
        prefix.append(prefix[-1] + g[1] - g[0])

    per: dict = {}
    for s in program:
        d = per.setdefault(s.name, {"count": 0, "s": 0.0, "idle_s": 0.0})
        d["count"] += 1
        d["s"] += (s.end_ns - s.start_ns) / 1e9
        d["idle_s"] += overlap(gaps, starts, prefix, s.start_ns, s.end_ns) / 1e9
    spans = {k: {"count_a_request": d["count"] / n_req, "s_a_request": d["s"] / n_req,
                 "idle_s_a_request": d["idle_s"] / n_req,
                 "busy_s_a_request": (d["s"] - d["idle_s"]) / n_req}
             for k, d in sorted(per.items(), key=lambda kv: -kv[1]["s"])}

    self_time: dict = {}
    for step in (s for s in program if s.name in ("step2", "step3")):
        kids = sorted((c for c in program if c.parent is step), key=lambda c: c.start_ns)
        cur, after = step.start_ns, "start"
        by = self_time.setdefault(step.name, {"length_s": 0.0, "self_s": 0.0, "after": {}})
        by["length_s"] += (step.end_ns - step.start_ns) / 1e9 / n_req
        for c in kids + [None]:
            nxt = step.end_ns if c is None else c.start_ns
            if nxt > cur:
                by["self_s"] += (nxt - cur) / 1e9 / n_req
                by["after"][after] = by["after"].get(after, 0.0) + (nxt - cur) / 1e9 / n_req
            if c is not None:
                cur, after = max(cur, c.end_ns), c.name
    for by in self_time.values():
        by["self_share"] = by["self_s"] / by["length_s"] if by["length_s"] else None

    return {
        "requests": len(rec.requests),
        "window_s": rec.window_s,
        "busy_s": trace.busy_seconds(ops, window),
        "idle_s": total_idle,
        "idle_share_program": sum(v for k, v in idle.items() if k in names) / total_idle
        if total_idle else None,
        "idle_share_request": idle.get("request", 0.0) / total_idle if total_idle else None,
        "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "spans": spans,
        "self": self_time,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("span_breakdown: this measurement needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cell = harness.load_cell(args.workload)
    result, rec = traced_run(cell, args.seed, args.seconds, torch.device("cuda", 0), T_START,
                             zrun.log)
    out = {"workload": args.workload, "seed": args.seed, "card": card, "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           **summary(rec)}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(result), flush=True)
    print(json.dumps(out), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
