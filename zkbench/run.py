"""Run one cell of the benchmark once and print its result line.

    python3 zkbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  With --trace 0 the line holds the cell's end-to-end metrics,
with --trace 1 its per-layer metrics, the device's busy and window seconds
and a breakdown.  The last lines on standard error, and the line's last key
`checks`, give every number compared with the reference beside its limit.
Without a CUDA device, or with fewer than the cell asks for, it exits
non-zero and prints no result; so it does if JAX or the JAX package was
loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".zkbench_cache"  # git-ignored, fixed: only a checkout's first run builds
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
# One intra-op thread: the port's host work is one Python thread, and a run
# offers its load from one process with few threads.  It does not steady the
# chunk cell: runs with one thread and with a thread a core spread alike, by
# the speed of the host's core (PERF.md, section 2).
os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, str(CHECKOUT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from zkbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"zkbench: {args.workload} needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), t_start=T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"zkbench: the run loaded {', '.join(found)}; no result")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    log(f"correct {str(result['correct']).lower()}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
