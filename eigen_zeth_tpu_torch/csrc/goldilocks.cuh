// Goldilocks field arithmetic, GF(p) with p = 2^64 - 2^32 + 1, for the
// kernels that work on the STARK side of the prover (Poseidon2 today; the
// NTT stage, the FRI fold and the constraint composition are to share it).
//
// An element is one canonical 64-bit word (< p), the bit pattern that the
// PyTorch code keeps in an int64 tensor.  Every function takes canonical
// operands and returns a canonical result, so a kernel's output equals the
// plain PyTorch version's (eigen_zeth_tpu_torch/ops/goldilocks.py) bit for
// bit.  The reduction uses 2^64 = 2^32 - 1 and 2^96 = -1 (mod p): a 128-bit
// product hi·2^64 + lo folds to lo - hi_hi + hi_lo·(2^32 - 1), and a carry or
// borrow out of bit 63 is worth 2^32 - 1.

#pragma once

#include <cstdint>

namespace ezt {
namespace gl {

typedef unsigned long long u64;

constexpr u64 kP = 0xFFFFFFFF00000001ull;
constexpr u64 kEps = 0xFFFFFFFFull;  // 2^64 mod p

__device__ __forceinline__ u64 add(u64 a, u64 b) {
  u64 s = a + b;
  if (s < a) s += kEps;  // the lost 2^64; a + b - p < p, so nothing follows
  return s >= kP ? s - kP : s;
}

__device__ __forceinline__ u64 sub(u64 a, u64 b) {
  u64 d = a - b;
  return a < b ? d + kP : d;
}

__device__ __forceinline__ u64 dbl(u64 a) { return add(a, a); }

// (hi·2^64 + lo) mod p for any 128-bit value.
__device__ __forceinline__ u64 reduce128(u64 lo, u64 hi) {
  const u64 hi_h = hi >> 32, hi_l = hi & kEps;
  u64 t0 = lo - hi_h;
  if (lo < hi_h) t0 -= kEps;  // borrowed 2^64: take 2^32 - 1 back
  const u64 t1 = (hi_l << 32) - hi_l;  // hi_l·(2^32 - 1), below 2^64
  u64 r = t0 + t1;
  if (r < t0) r += kEps;
  return r >= kP ? r - kP : r;
}

// Four 32 x 32 -> 64 multiply-adds for the 128-bit product, then the fold.
__device__ __forceinline__ u64 mul(u64 a, u64 b) {
  return reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ u64 sqr(u64 a) { return mul(a, a); }

}  // namespace gl
}  // namespace ezt
