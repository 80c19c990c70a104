"""Kernel E's own arithmetic on the CPU: csrc/goldilocks.cuh,
csrc/poseidon2_gl.cuh and csrc/poseidon2_gl_rows.cuh built with the host
C++ compiler.

The headers compile without nvcc; the PTX carry-flag operations are then
emulated, and the emulation refuses a chain that hands an addition's carry
to a subtraction or the reverse (such chains computed wrong words on the
H100).  A small harness permutes states and runs the sponge with the
permutation the kernel runs, on the constants as ops/kernels.py lays them
out, and the results must equal `perm_host` and `hash_elements_host`.
Edge lanes (0, 1, p - 1, p - 2^32, 2^32 - 1, 2^32) and seeded random states.
A second harness runs the verifier-rows entry's per-thread work (each
Merkle path's walk, then each slot's 32 rows) on a plan of the verifier
trace, and its rows must equal the plain version's (`recursion.
_fill_perm_rows_plain`) on the same plan, plan words at and above p included.
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


ROWS_HARNESS = r"""
#include <cstdio>
#include <vector>
#include "poseidon2_gl_rows.cuh"
using ezt::gl::u64;
namespace p2 = ezt::poseidon2;
namespace rw = ezt::poseidon2::rows;
struct Sink {  // one slot's rows, row after row
  u64 row_[rw::kCols];
  u64* out;
  void put(int col, u64 v) { row_[col] = v; }
  void row(int r) { for (int i = 0; i < rw::kCols; ++i) out[r * rw::kCols + i] = row_[i]; }
};
// stdin: the 153 constant words; queries, slots; the paths as (first,
// depth) pairs after their count; the plan's queries x slots x 17 words.
// stdout: the 32 x 48 words of each slot, query-major
int main() {
  p2::Consts c;
  u64* w = reinterpret_cast<u64*>(&c);
  for (int i = 0; i < 153; ++i) if (scanf("%llu", &w[i]) != 1) return 1;
  long q, s, n;
  if (scanf("%ld %ld %ld", &q, &s, &n) != 3) return 1;
  std::vector<long> first(n), depth(n);
  for (long k = 0; k < n; ++k) if (scanf("%ld %ld", &first[k], &depth[k]) != 2) return 1;
  std::vector<u64> plan(q * s * rw::kPlanWords);
  for (auto& v : plan) if (scanf("%llu", &v) != 1) return 1;
  std::vector<u64> out(rw::kRows * rw::kCols);
  try {
    for (long k = 0; k < n; ++k)
      for (long i = 0; i < q; ++i)
        rw::walk_path(&plan[(i * s + first[k]) * rw::kPlanWords], depth[k], c);
    for (long e = 0; e < q * s; ++e) {
      u64 st[p2::kWidth];
      for (int j = 0; j < p2::kWidth; ++j) st[j] = plan[e * rw::kPlanWords + j];
      Sink sink{{}, out.data()};
      rw::slot_rows(st, c, sink);
      for (u64 v : out) printf("%llu ", v);
      printf("\n");
    }
  } catch (const char* what) {
    fprintf(stderr, "%s\n", what);
    return 2;
  }
  return 0;
}
"""


def _build(tmp_path, source: str):
    cxx = shutil.which("g++") or shutil.which("c++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    src = tmp_path / "harness.cpp"
    src.write_text(source)
    exe = tmp_path / "harness"
    csrc = Path(kernels.CSRC)
    subprocess.run([cxx, "-O1", "-std=c++17", "-I", str(csrc), "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True, timeout=120)
    return exe


def test_kernel_arithmetic_built_on_the_host_equals_the_reference(tmp_path):
    exe = _build(tmp_path, HARNESS)
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


@pytest.mark.parametrize("n_c,terminal", [(8, None), (32, 32)], ids=["zero-layer", "two-fold-layers"])
def test_verifier_rows_built_on_the_host_equal_the_plain_fill(tmp_path, n_c, terminal):
    from eigen_zeth_tpu_torch.models import recursion as rec

    exe = _build(tmp_path, ROWS_HARNESS)
    queries = 3
    plan = rec.PermPlan.empty(rec.Schedule(n_c, terminal), queries)
    rng = np.random.default_rng(0x5EEE + n_c)
    words = rng.integers(0, P, plan.words.shape, dtype=np.uint64)
    # plan words at and above p: the fill takes them below p
    edge = np.asarray([0, P - 1, P, P + 5, (1 << 64) - 1], dtype=np.uint64)
    mask = rng.random(plan.words.shape) < 0.3
    words[mask] = rng.choice(edge, int(mask.sum()))
    words[:, :, rec.W + 4] = rng.integers(0, 2, plan.words.shape[:2], dtype=np.uint64)
    plan.words[:] = words
    lines = [" ".join(map(str, kernels.poseidon2_const_words())),
             f"{queries} {plan.slots} {len(plan.chains)}",
             " ".join(f"{f} {d}" for f, d in plan.chains),
             " ".join(map(str, plan.words.reshape(-1).tolist()))]
    run = subprocess.run([str(exe)], input="\n".join(lines), capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stderr
    got = np.asarray([[int(v) for v in line.split()] for line in run.stdout.strip().splitlines()],
                     dtype=np.uint64).reshape(queries, plan.slots * rec.SLOT, rec.PERM_COLS)
    want = np.zeros((queries, plan.period, rec.PERM_COLS), dtype=np.uint64)
    rec._fill_perm_rows_plain(want, plan)
    assert (got == want[:, : plan.slots * rec.SLOT]).all()
    assert (want[:, plan.slots * rec.SLOT :] == 0).all()  # the pads: not permutation slots
