#!/usr/bin/env python3
"""Count the machine operations of each of the port's CUDA kernels.

    python3 scripts/sass_histogram.py [names of operations to list, default 14]

Builds the kernels (eigen_zeth_tpu_torch/csrc, as at first use), disassembles
the library with the CUDA toolkit's `cuobjdump -sass` and prints, per kernel,
how often each operation occurs in its code.  Static counts: a loop body
counts once.  What it is for: one Montgomery product should hold 136 wide
multiply-adds (IMAD.WIDE.U32, with .X where a carry comes in) and no moves
between them; a change to csrc/bn254_field.cuh that loses that shows here.
Needs nvcc and cuobjdump, no GPU.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from eigen_zeth_tpu_torch.ops import kernels  # noqa: E402


def main() -> int:
    top = int(sys.argv[1]) if len(sys.argv) > 1 else 14
    lib = kernels.build()
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts: dict = collections.defaultdict(collections.Counter)
    kernel = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and kernel:
            counts[kernel][m.group(1)] += 1
    for kernel, ops in counts.items():
        print(f"{kernel}  ({sum(ops.values())} instructions)")
        for op, k in ops.most_common(top):
            print(f"   {k:6d} {op}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
