"""The port's batched keccak256 (ops/keccak.py: the plain version of kernel
G on CPU tensors) against the JAX package's `keccak256` and `keccak256_host`,
and kernel G's own permutation (csrc/keccak.cuh, built with the host C++
compiler) against the host reference.

Messages from numpy with a fixed seed at the edge lengths of the 136-byte
rate (0, 1, 135, 136, 137, 272 and 300 bytes: one, two and three blocks, the
padding byte alone in a block of its own), and the known answers of
keccak256(b"") and keccak256(b"abc").  Tolerance: none, byte equality.  The
header build skips where no C++ compiler is installed.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from eigen_zeth_tpu.ops import keccak as jkeccak
from eigen_zeth_tpu_torch.ops import keccak

LENGTHS = [0, 1, 135, 136, 137, 272, 300]
CSRC = Path(keccak.__file__).resolve().parent.parent / "csrc"

HARNESS = r"""
#include <cstdio>
#include "keccak.cuh"
using ezt::keccak::u64;
// stdin: n, then per message its block count and its padded lanes;
// stdout: the digest's four lanes of each message
int main() {
  long n;
  if (scanf("%ld", &n) != 1) return 1;
  for (long r = 0; r < n; ++r) {
    long blocks;
    if (scanf("%ld", &blocks) != 1) return 1;
    u64 a[25] = {0};
    for (long b = 0; b < blocks; ++b) {
      for (int l = 0; l < ezt::keccak::kRateLanes; ++l) {
        u64 v;
        if (scanf("%llu", &v) != 1) return 1;
        a[l] ^= v;
      }
      ezt::keccak::permute(a);
    }
    for (int l = 0; l < ezt::keccak::kDigestLanes; ++l) printf("%llu ", a[l]);
    printf("\n");
  }
  return 0;
}
"""


def messages(length, n=6):
    return np.random.default_rng(length).integers(0, 256, (n, length), dtype=np.uint8)


@pytest.mark.parametrize("length", LENGTHS)
def test_plain_keccak256_equals_jax(length):
    m = messages(length)
    got = keccak.keccak256(torch.from_numpy(m))
    assert got.dtype is torch.uint8 and got.shape == (len(m), 32)
    assert (got.numpy() == np.asarray(jkeccak.keccak256(m))).all()
    for i in range(len(m)):
        assert bytes(got[i].numpy()) == jkeccak.keccak256_host(bytes(m[i]))


def test_known_answers_and_shapes():
    empty = "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    abc = "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45"
    assert keccak.keccak256(np.zeros(0, dtype=np.uint8)).numpy().tobytes().hex() == empty
    assert keccak.keccak256(np.frombuffer(b"abc", np.uint8)).numpy().tobytes().hex() == abc
    assert keccak.keccak256(np.zeros((0, 5), dtype=np.uint8)).shape == (0, 32)
    with pytest.raises(TypeError):
        keccak.keccak256(torch.zeros((1, 4), dtype=torch.int32))


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not available")
def test_kernel_permutation_built_for_the_host(tmp_path):
    src = tmp_path / "harness.cpp"
    src.write_text(HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(["g++", "-O1", "-std=c++17", f"-I{CSRC}", str(src), "-o", str(exe)],
                   check=True, capture_output=True)
    cases = [m for length in LENGTHS for m in messages(length, 2)]
    lines = [str(len(cases))]
    for m in cases:
        lanes = keccak.pad_lanes(torch.from_numpy(m[None].copy())).numpy().view(np.uint64)[:, 0]
        lines.append(f"{len(lanes) // 17} " + " ".join(str(int(v)) for v in lanes))
    out = subprocess.run([str(exe)], input="\n".join(lines), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    for m, line in zip(cases, out):
        digest = b"".join(int(v).to_bytes(8, "little") for v in line.split())
        assert digest == jkeccak.keccak256_host(bytes(m))
