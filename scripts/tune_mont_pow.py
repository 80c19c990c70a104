#!/usr/bin/env python3
"""Compare the sliding window's width of the port's power kernel
(`mont_pow` in eigen_zeth_tpu_torch/csrc/mont_mul.cu) on one NVIDIA GPU.

    python3 scripts/tune_mont_pow.py

Times a^(q - 2) (Fermat inversion over BN254's Fq, the power the paths take)
with windows of 4 and of 5 bits at (16, 2^18), (16, 2^16) and (16, 32)
random canonical elements: CUDA events around 20 back-to-back launches,
median of 3, the widths taken in turns twice so that a drift of the card's
clock shows; each width's first 32 outputs are held to the plain version.
Prints each width's chain (products, squarings) beside its times.
`kernels.POW_WINDOW` is the width chosen from this table.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from eigen_zeth_tpu_torch.ops import bn254, kernels  # noqa: E402

BATCHES = (1 << 18, 1 << 16, 32)
WIDTHS = (4, 5)


def time_ms(fn, reps: int = 20, groups: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("tune_mont_pow: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    ctx, e = bn254.fq(), bn254.Q - 2
    rows = {(w, n): [] for w in WIDTHS for n in BATCHES}
    for n in BATCHES:
        x = torch.randint(0, 1 << 16, (16, n), generator=gen, device=dev, dtype=torch.int32)
        x[15] %= bn254.Q >> 240
        schedules = {w: kernels.pow_schedule_struct(e, w) for w in WIDTHS}
        want = kernels.mont_pow_plain(ctx, x[:, :32], e)
        for w, s in schedules.items():
            if not torch.equal(kernels._launch_pow(ctx, x, s)[:, :32], want):
                raise AssertionError(f"mont_pow: width {w} disagrees with the plain version")
        for _ in range(2):
            for w, s in schedules.items():
                rows[(w, n)].append(time_ms(lambda: kernels._launch_pow(ctx, x, s)))
    print("mont_pow to q - 2; ms per launch, two rounds")
    for w in WIDTHS:
        products, squarings = kernels.pow_chain(kernels.pow_schedule(e, w))
        times = "   ".join(f"(16, {n}) " + " ".join(f"{t:.4f}" for t in rows[(w, n)])
                           for n in BATCHES)
        print(f"width {w}: {products} products, {squarings} squarings   {times}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
