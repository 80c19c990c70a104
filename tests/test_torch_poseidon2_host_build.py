"""Kernel E's own arithmetic on the CPU: csrc/goldilocks.cuh and
csrc/poseidon2_gl.cuh built with the host C++ compiler.

The headers compile without nvcc; the PTX carry-flag operations are then
emulated, and the emulation refuses a chain that hands an addition's carry
to a subtraction or the reverse (such chains computed wrong words on the
H100).  A small harness permutes states and runs the sponge with the
permutation the kernel runs, on the constants as ops/kernels.py lays them
out, and the results must equal `perm_host` and `hash_elements_host`.
Edge lanes (0, 1, p - 1, p - 2^32, 2^32 - 1, 2^32) and seeded random states.
Tolerance: none — exact integer equality.  Skips where no C++ compiler is
installed.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from eigen_zeth_tpu_torch.ops import kernels
from eigen_zeth_tpu_torch.ops import poseidon as ps

P = ps.gl.P
EDGE = [0, 1, P - 1, P - (1 << 32), (1 << 32) - 1, 1 << 32]

HARNESS = r"""
#include <cstdio>
#include "poseidon2_gl.cuh"
using ezt::gl::u64;
namespace p2 = ezt::poseidon2;
// stdin: the 153 constant words, then n states of 12 words, then m rows as
// (k, k words); stdout: each permuted state, then each row's digest, canonical
int main() {
  p2::Consts c;
  u64* w = reinterpret_cast<u64*>(&c);
  for (int i = 0; i < 153; ++i) if (scanf("%llu", &w[i]) != 1) return 1;
  long n, m, k;
  if (scanf("%ld", &n) != 1) return 1;
  try {
    for (long r = 0; r < n; ++r) {
      u64 s[12];
      for (int i = 0; i < 12; ++i) if (scanf("%llu", &s[i]) != 1) return 1;
      p2::permute(s, c);
      for (int i = 0; i < 12; ++i) printf("%llu ", ezt::gl::lazy::canon(s[i]));
      printf("\n");
    }
    if (scanf("%ld", &m) != 1) return 1;
    for (long r = 0; r < m; ++r) {
      if (scanf("%ld", &k) != 1) return 1;
      u64 s[12] = {0};
      s[8] = static_cast<u64>(k);
      for (long b = 0; b < (k > 0 ? (k + 7) / 8 : 1); ++b) {
        for (long j = 0; j < 8 && b * 8 + j < k; ++j) {
          u64 v;
          if (scanf("%llu", &v) != 1) return 1;
          s[j] = ezt::gl::lazy::add(s[j], v);
        }
        p2::permute(s, c);
      }
      for (int i = 0; i < 4; ++i) printf("%llu ", ezt::gl::lazy::canon(s[i]));
      printf("\n");
    }
  } catch (const char* what) {
    fprintf(stderr, "%s\n", what);
    return 2;
  }
  return 0;
}
"""


def test_kernel_arithmetic_built_on_the_host_equals_the_reference(tmp_path):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = tmp_path / "harness.cpp"
    src.write_text(HARNESS)
    exe = tmp_path / "harness"
    csrc = Path(kernels.CSRC)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", str(csrc), "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True, timeout=120)
    rng = np.random.default_rng(0x5EED)
    states = [[v] * 12 for v in EDGE]
    states += [[int(v) for v in rng.choice(np.asarray(EDGE, dtype=np.uint64), 12)]
               for _ in range(40)]
    states += [[int(v) for v in row] for row in rng.integers(0, P, (60, 12), dtype=np.uint64)]
    rows = [[int(v) for v in rng.integers(0, P, k, dtype=np.uint64)] for k in (0, 1, 7, 8, 9, 17, 216)]
    rows += [[P - 1] * 24, [0] * 16]
    lines = [" ".join(map(str, kernels.poseidon2_const_words())), str(len(states))]
    lines += [" ".join(map(str, s)) for s in states]
    lines += [str(len(rows))] + [" ".join(map(str, [len(r)] + r)) for r in rows]
    run = subprocess.run([str(exe)], input="\n".join(lines), capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    out = [[int(v) for v in line.split()] for line in run.stdout.strip().splitlines()]
    assert len(out) == len(states) + len(rows)
    for got, state in zip(out, states):
        assert got == ps.perm_host(state)
    for got, row in zip(out[len(states):], rows):
        assert got == ps.hash_elements_host(row)
