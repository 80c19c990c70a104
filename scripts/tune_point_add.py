#!/usr/bin/env python3
"""Compare block sizes and `__launch_bounds__` of the port's point-add kernel
(eigen_zeth_tpu_torch/csrc/point_add.cu) on one NVIDIA GPU.

    python3 scripts/tune_point_add.py

Builds the source once per variant (threads per block, blocks per SM asked of
ptxas for the G1 form and for the G2 form, whose point takes two lanes:
EZT_ADD_G1_BLOCKS and EZT_ADD_G2_LANE_BLOCKS; all nvcc runs start together),
prints ptxas's registers and spills, and times the G1 and the G2 add at
2^18 pairs of random canonical field elements: CUDA events around 20
back-to-back launches, median of 3, the variants taken in turns twice so
that a drift of the card's clock shows.  The operands (144 and 288 MB)
exceed the L2 cache.  The source's defaults are the variant chosen from this
table; it writes nothing outside eigen_zeth_tpu_torch/_build/tune/.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from eigen_zeth_tpu_torch.ops import bn254, kernels  # noqa: E402

N = 1 << 18
# (threads, G1 blocks per SM, G2 blocks per SM)
VARIANTS = [(64, 4, 4), (64, 4, 6), (64, 4, 8), (128, 4, 2), (128, 4, 3), (128, 4, 4),
            (128, 4, 5), (128, 4, 6), (256, 2, 1), (256, 2, 2), (256, 2, 3), (512, 1, 1)]


def build(out_dir: Path):
    jobs = []
    for threads, g1, g2 in VARIANTS:
        lib = out_dir / f"point_add_{threads}_{g1}_{g2}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", f"-DEZT_ADD_THREADS={threads}",
               f"-DEZT_ADD_G1_BLOCKS={g1}", f"-DEZT_ADD_G2_LANE_BLOCKS={g2}", "-o", str(lib),
               str(kernels.CSRC / "point_add.cu")]
        jobs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True)))
    libs = []
    for lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(log)
        usage = re.findall(r"(FqField|Fq2Lanes).*?(\d+) bytes spill stores.*?Used (\d+) registers",
                           log, flags=re.S)
        # the entries' types are the package's own (kernels.SIGNATURES)
        fns = kernels.bind(ctypes.CDLL(str(lib)), ("point_add", "point_add_g2"))
        libs.append((fns, {field: (int(r), int(sp)) for field, sp, r in usage}))
    return libs


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
        raise SystemExit("tune_point_add: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out_dir = kernels.BUILD_ROOT / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = build(out_dir)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    planes = []
    for _ in range(18):
        t = torch.randint(0, 1 << 16, (16, N), generator=gen, device=dev, dtype=torch.int32)
        t[15] %= bn254.Q >> 240
        planes.append(t)
    outs = [torch.empty_like(planes[0]) for _ in range(6)]
    qw = kernels._words(bn254.Q)
    q_ptr, n0 = ctypes.cast(qw, ctypes.c_void_p), bn254.fq().n0_32
    stream = torch.cuda.current_stream().cuda_stream
    g1_args = [t.data_ptr() for t in planes[:6] + outs[:3]]
    g2_array = (ctypes.c_void_p * 18)(*(t.data_ptr() for t in planes[:12] + outs))
    g2_ptr = ctypes.cast(g2_array, ctypes.c_void_p)

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed with cudaError {rc}")

    def g1(lib):
        return lambda: check(lib["point_add"](*g1_args, N, q_ptr, n0, None, 0, stream))

    def g2(lib):
        return lambda: check(lib["point_add_g2"](g2_ptr, N, q_ptr, n0, None, 0, stream))

    rows = {v: [] for v in VARIANTS}
    for _ in range(2):
        for variant, (lib, _) in zip(VARIANTS, libs):
            rows[variant].append((time_ms(g1(lib)), time_ms(g2(lib))))
    print(f"point add at (16, {N}); ms per launch, two rounds")
    print("threads  G1 blocks/SM  regs  spill B   G1 ms            "
          "G2 blocks/SM  regs  spill B   G2 ms")
    for (threads, b1, b2), (_, usage) in zip(VARIANTS, libs):
        (r1, s1), (r2, s2) = usage["FqField"], usage["Fq2Lanes"]
        t = rows[(threads, b1, b2)]
        print(f"{threads:7d}  {b1:12d}  {r1:4d}  {s1:7d}   {t[0][0]:.4f} {t[1][0]:.4f}    "
              f"{b2:12d}  {r2:4d}  {s2:7d}   {t[0][1]:.4f} {t[1][1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
