#!/usr/bin/env python3
"""Stage times of one chunk attestation on the GPU, by block size.

    python3 scripts/attestation_stages.py [log2 of COMP_BLOCK ...]

Proves one chunk at the production shape (4,096 rows, blowup 4, 32 queries,
terminal 64) and attests it (`recursion.attest_chunk`, 30 queries: a 2^18-row
trace of 216 columns, extended to 2^21) once per composition block size
(`air.COMP_BLOCK`; default 2^17 to 2^20) after one warm-up attestation that
fills the per-AIR caches (periodic columns, denominators, NTT plans).  For
every run it prints the synchronised wall time of each stage (host trace
build, LDE, Merkle commit, composition, FRI, openings), the peak device
memory, and kernel E's launches; every attestation must equal the first.
Needs a CUDA device; the kernels are built at first use.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from eigen_zeth_tpu_torch.models import air, recursion, stark  # noqa: E402
from eigen_zeth_tpu_torch.ops import kernels  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("attestation_stages: this measurement needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    device = torch.device("cuda")
    logs = [int(a) for a in sys.argv[1:]] or [17, 18, 19, 20]
    params = stark.StarkParams(blowup=4, num_queries=32, terminal_size=64)
    child = stark.prove_chunk(list(range(1, 4095)), 7, params, n_rows=4096, device=device)

    stages, last = {}, [0.0]

    def on_stage(name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - last[0]
        last[0] = now

    air.STAGE_HOOK = on_stage
    first = None
    for run, log2 in enumerate([logs[0]] + logs):
        air.COMP_BLOCK = 1 << log2
        stages.clear()
        torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launches()
        torch.cuda.synchronize()
        last[0] = t0 = time.perf_counter()
        att = recursion.attest_chunk(child, num_queries_agg=30, device=device)
        total = time.perf_counter() - t0
        first = first or att
        if att != first:
            raise AssertionError(f"the attestation changed with COMP_BLOCK = 2^{log2}")
        what = "warm-up, " if run == 0 else ""
        print(f"{what}COMP_BLOCK 2^{log2}: " + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items())
              + f"; total {total:.3f} s; peak {torch.cuda.max_memory_allocated(device) / 2**20:.0f} MiB; "
              f"poseidon2 launches {kernels.LAUNCHES['poseidon2']}", flush=True)
    digest = recursion.verify_attestation(first, expected_queries=32, expected_rows=4096,
                                          expected_terminal=64)
    print(f"verify_attestation accepts it; chunk digest {digest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
