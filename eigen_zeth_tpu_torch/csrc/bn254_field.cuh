// Montgomery field arithmetic for the BN254 kernels, one element per thread.
//
// Counterpart of `_field_ops` in eigen_zeth_tpu/ops/pallas/ec_pl.py:29
// (mont_mul, add, sub, dbl, is_zero, select), plus what the scan-step and
// mixed-add kernels share (neg, the unsafe mixed add).  The TPU kernels hold an
// element as 16 limbs of 16 bits in uint32 lanes because the VPU has no wide
// multiplier; here an element lives in eight 32-bit registers and the CIOS
// inner step uses the 32x32->64 multiplier (a*b + t + c < 2^64).  R stays
// 2^256, so the Montgomery form, and every output bit, is the same as the
// JAX package's.
//
// Memory layout at the kernel boundary is the package's public one: a batch
// of B elements is a limb-major (16, B) int32 tensor of 16-bit limbs, so
// thread i reads limb k at k*B + i and neighbouring threads touch
// neighbouring addresses (coalesced).  Outputs are canonical (< q).

#pragma once

#include <cstdint>

namespace ezt {

constexpr int kWords = 8;  // 32-bit words per element: R = 2^256

// The modulus travels by value in the kernel's parameter space, so every
// q[j] read below is a constant-bank operand of the multiply.
struct Modulus {
  uint32_t q[kWords];
  uint32_t n0;  // -q^{-1} mod 2^32
};

struct Fe {
  uint32_t w[kWords];
};

__device__ __forceinline__ Fe load_fe(const int32_t* __restrict__ p, int64_t n,
                                      int64_t i) {
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint32_t lo = static_cast<uint32_t>(p[(2 * k) * n + i]);
    uint32_t hi = static_cast<uint32_t>(p[(2 * k + 1) * n + i]);
    r.w[k] = lo | (hi << 16);
  }
  return r;
}

__device__ __forceinline__ void store_fe(int32_t* __restrict__ p, int64_t n,
                                         int64_t i, const Fe& a) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    p[(2 * k) * n + i] = static_cast<int32_t>(a.w[k] & 0xFFFFu);
    p[(2 * k + 1) * n + i] = static_cast<int32_t>(a.w[k] >> 16);
  }
}

__device__ __forceinline__ Fe select_fe(bool pred, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = pred ? a.w[k] : b.w[k];
  return r;
}

__device__ __forceinline__ bool is_zero_fe(const Fe& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) acc |= a.w[k];
  return acc == 0;
}

__device__ __forceinline__ Fe zero_fe() {
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = 0;
  return r;
}

// a + extra*2^256 - q when that is >= 0, else a (input < 2q).
__device__ __forceinline__ Fe cond_sub_q(const Fe& a, uint32_t extra,
                                         const Modulus& m) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t s = static_cast<uint64_t>(a.w[k]) - m.q[k] - borrow;
    d.w[k] = static_cast<uint32_t>(s);
    borrow = static_cast<uint32_t>(s >> 63);
  }
  return select_fe(extra != 0 || borrow == 0, d, a);
}

__device__ __forceinline__ Fe add_fe(const Fe& a, const Fe& b,
                                     const Modulus& m) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    c += static_cast<uint64_t>(a.w[k]) + b.w[k];
    s.w[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return cond_sub_q(s, static_cast<uint32_t>(c), m);
}

__device__ __forceinline__ Fe dbl_fe(const Fe& a, const Modulus& m) {
  return add_fe(a, a, m);
}

// a - b, adding q back on borrow.
__device__ __forceinline__ Fe sub_fe(const Fe& a, const Fe& b,
                                     const Modulus& m) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t s = static_cast<uint64_t>(a.w[k]) - b.w[k] - borrow;
    d.w[k] = static_cast<uint32_t>(s);
    borrow = static_cast<uint32_t>(s >> 63);
  }
  Fe e;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    c += static_cast<uint64_t>(d.w[k]) + m.q[k];
    e.w[k] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return select_fe(borrow != 0, e, d);
}

// CIOS Montgomery product a*b*2^-256 mod q for canonical a, b.
__device__ __forceinline__ Fe mont_mul_fe(const Fe& a, const Fe& b,
                                          const Modulus& m) {
  uint32_t t[kWords + 2];
#pragma unroll
  for (int k = 0; k < kWords + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      uint64_t s = static_cast<uint64_t>(a.w[j]) * b.w[i] + t[j] + c;
      t[j] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[kWords]) + c;
    t[kWords] = static_cast<uint32_t>(s);
    t[kWords + 1] = static_cast<uint32_t>(s >> 32);
    uint32_t mi = t[0] * m.n0;
    s = static_cast<uint64_t>(mi) * m.q[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < kWords; ++j) {
      s = static_cast<uint64_t>(mi) * m.q[j] + t[j] + c;
      t[j - 1] = static_cast<uint32_t>(s);
      c = s >> 32;
    }
    s = static_cast<uint64_t>(t[kWords]) + c;
    t[kWords - 1] = static_cast<uint32_t>(s);
    t[kWords] = t[kWords + 1] + static_cast<uint32_t>(s >> 32);
  }
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = t[k];
  return cond_sub_q(r, t[kWords], m);
}

// -a mod q, with -0 = 0, so the output stays canonical (q - 0 would be q).
__device__ __forceinline__ Fe neg_fe(const Fe& a, const Modulus& m) {
  Fe d;
  uint32_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t s = static_cast<uint64_t>(m.q[k]) - a.w[k] - borrow;
    d.w[k] = static_cast<uint32_t>(s);
    borrow = static_cast<uint32_t>(s >> 63);
  }
  return select_fe(is_zero_fe(a), a, d);
}

// Unsafe mixed add (madd-2007-bl with Z2 = 1, 7M + 4S) of the Jacobian point
// (X1, Y1, Z1) and the affine point (X2, Y2): no doubling and no infinity
// branch.  Counterpart of eigen_zeth_tpu/ops/bn254.py:point_madd_unsafe and
// of the body shared by `_point_madd_kernel` and `_scan_step_kernel` in
// eigen_zeth_tpu/ops/pallas/ec_pl.py.  Returns the `bad` test, H == 0 or
// Z1 == 0 (P == +-Q, or the accumulator at infinity): the outputs are then
// meaningless and the caller must discard or recompute them.
__device__ __forceinline__ bool madd_unsafe_fe(const Fe& X1, const Fe& Y1,
                                               const Fe& Z1, const Fe& X2,
                                               const Fe& Y2, Fe& X3, Fe& Y3,
                                               Fe& Z3, const Modulus& m) {
  const Fe z1z1 = mont_mul_fe(Z1, Z1, m);
  const Fe u2 = mont_mul_fe(X2, z1z1, m);
  const Fe s2 = mont_mul_fe(Y2, mont_mul_fe(Z1, z1z1, m), m);
  const Fe h = sub_fe(u2, X1, m);
  const Fe hh = mont_mul_fe(h, h, m);
  const Fe i_ = dbl_fe(dbl_fe(hh, m), m);
  const Fe j_ = mont_mul_fe(h, i_, m);
  const Fe r = dbl_fe(sub_fe(s2, Y1, m), m);
  const Fe v = mont_mul_fe(X1, i_, m);
  X3 = sub_fe(sub_fe(mont_mul_fe(r, r, m), j_, m), dbl_fe(v, m), m);
  Y3 = sub_fe(mont_mul_fe(r, sub_fe(v, X3, m), m),
              dbl_fe(mont_mul_fe(Y1, j_, m), m), m);
  const Fe zh = add_fe(Z1, h, m);
  Z3 = sub_fe(sub_fe(mont_mul_fe(zh, zh, m), z1z1, m), hh, m);
  return is_zero_fe(h) || is_zero_fe(Z1);
}

}  // namespace ezt
