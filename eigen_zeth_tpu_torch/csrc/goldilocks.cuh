// Goldilocks field arithmetic, GF(p) with p = 2^64 - 2^32 + 1, for the
// kernels that work on the STARK side of the prover (Poseidon2 today; the
// NTT stage, the FRI fold and the constraint composition are to share it).
//
// Two forms of an element live here.
//
// Canonical (`add`, `sub`, `mul`, ...): one 64-bit word below p, the bit
// pattern that the PyTorch code keeps in an int64 tensor.  Every function
// takes canonical operands and returns a canonical result, so an output
// equals the plain PyTorch version's (eigen_zeth_tpu_torch/ops/goldilocks.py)
// bit for bit.
//
// Lazy (namespace `lazy`): a word is any 64-bit value congruent to the
// element, below 2^64 but not necessarily below p.  Sums and products gather
// in accumulators of 96 or 128 bits, three or four 32-bit words, on PTX carry
// chains (`add.cc` / `addc`, `mad.lo.cc` / `madc.hi.cc`) with no compare per
// term, and one `reduce` folds an accumulator back to a word.  `canon` takes
// a word below p where an output leaves the kernel.  Every function states
// the bound it relies on; the caller keeps it.
//
// Both reductions use 2^64 = 2^32 - 1 and 2^96 = -1 (mod p): a 128-bit value
// x0 + x1·2^32 + x2·2^64 + x3·2^96 (32-bit words) is congruent to
// (x1:x0) + x2·2^32 - x2 - x3, and a carry or borrow out of bit 63 is worth
// 2^32 - 1.
//
// The header also compiles with a host C++ compiler, where the carry flag of
// the PTX primitives is emulated, so the lazy arithmetic can be run against
// the reference on a machine without a GPU.

#pragma once

#include <cstdint>

#if !defined(__CUDACC__)
#define __device__
#define __forceinline__ inline
#endif

namespace ezt {
namespace gl {

typedef unsigned long long u64;
typedef unsigned int u32;

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

// The 128-bit product, then the fold.
__device__ __forceinline__ u64 mul(u64 a, u64 b) {
#if defined(__CUDACC__)
  return reduce128(a * b, __umul64hi(a, b));
#else
  const unsigned __int128 w = static_cast<unsigned __int128>(a) * b;
  return reduce128(static_cast<u64>(w), static_cast<u64>(w >> 64));
#endif
}

__device__ __forceinline__ u64 sqr(u64 a) { return mul(a, a); }

// ---------------------------------------------------------------------------
// PTX with the carry flag.  Each operation is its own `asm volatile`
// statement: volatile statements keep their order, and the compiler emits
// nothing of its own that writes the flag, so the flag set by one statement
// reaches the next (as in bn254_field.cuh).  A flag set by an addition is
// read only by an addition, one set by a subtraction only by a subtraction:
// chains that handed an addition's carry to a subtraction (or the reverse)
// computed wrong words on the H100, though they are exact on paper.  The
// host build refuses such a chain.

namespace ptx {

#if defined(__CUDACC__)

#define EZT_GL_ASM3(name, op)                                                \
  __device__ __forceinline__ u32 name(u32 a, u32 b, u32 c) {                 \
    u32 r;                                                                   \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));  \
    return r;                                                                \
  }
#define EZT_GL_ASM2(name, op)                                        \
  __device__ __forceinline__ u32 name(u32 a, u32 b) {                \
    u32 r;                                                           \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));      \
    return r;                                                        \
  }

EZT_GL_ASM2(mul_lo, "mul.lo.u32")
EZT_GL_ASM2(mul_hi, "mul.hi.u32")
EZT_GL_ASM3(mad_lo_cc, "mad.lo.cc.u32")    // lo(a·b) + c, sets the flag
EZT_GL_ASM3(madc_lo_cc, "madc.lo.cc.u32")  // lo(a·b) + c + flag, sets it
EZT_GL_ASM3(madc_hi_cc, "madc.hi.cc.u32")  // hi(a·b) + c + flag, sets it
EZT_GL_ASM3(madc_hi, "madc.hi.u32")        // hi(a·b) + c + flag
EZT_GL_ASM2(add_cc, "add.cc.u32")
EZT_GL_ASM2(addc_cc, "addc.cc.u32")
EZT_GL_ASM2(addc, "addc.u32")  // reads the flag, leaves it as it was
EZT_GL_ASM2(sub_cc, "sub.cc.u32")  // the flag is the borrow
EZT_GL_ASM2(subc_cc, "subc.cc.u32")
EZT_GL_ASM2(subc, "subc.u32")

#undef EZT_GL_ASM3
#undef EZT_GL_ASM2

#else  // host build: the same operations on an emulated flag

struct Flag {
  u32 bit = 0;
  char kind = 0;  // '+' set by an addition, '-' by a subtraction
};
inline Flag& flag() {
  static thread_local Flag f;
  return f;
}
inline u32 set(u64 w, char kind) {
  flag() = {static_cast<u32>(w >> 32) & 1u, kind};
  return static_cast<u32>(w);
}
inline u32 carry() {  // an addition reads the flag
  if (flag().kind != '+') throw "an addition reads a flag no addition set";
  return flag().bit;
}
inline u32 borrow() {  // a subtraction reads the flag
  if (flag().kind != '-') throw "a subtraction reads a flag no subtraction set";
  return flag().bit;
}
inline u64 prod(u32 a, u32 b) { return static_cast<u64>(a) * b; }
inline u32 mul_lo(u32 a, u32 b) { return static_cast<u32>(prod(a, b)); }
inline u32 mul_hi(u32 a, u32 b) { return static_cast<u32>(prod(a, b) >> 32); }
inline u32 mad_lo_cc(u32 a, u32 b, u32 c) { return set(u64{mul_lo(a, b)} + c, '+'); }
inline u32 madc_lo_cc(u32 a, u32 b, u32 c) { return set(u64{mul_lo(a, b)} + c + carry(), '+'); }
inline u32 madc_hi_cc(u32 a, u32 b, u32 c) { return set(u64{mul_hi(a, b)} + c + carry(), '+'); }
inline u32 madc_hi(u32 a, u32 b, u32 c) { return mul_hi(a, b) + c + carry(); }
inline u32 add_cc(u32 a, u32 b) { return set(u64{a} + b, '+'); }
inline u32 addc_cc(u32 a, u32 b) { return set(u64{a} + b + carry(), '+'); }
inline u32 addc(u32 a, u32 b) { return a + b + carry(); }
inline u32 sub_cc(u32 a, u32 b) { return set(u64{a} - b, '-'); }
inline u32 subc_cc(u32 a, u32 b) { return set(u64{a} - b - borrow(), '-'); }
inline u32 subc(u32 a, u32 b) { return a - b - borrow(); }

#endif

}  // namespace ptx

// ---------------------------------------------------------------------------
// the lazy form

namespace lazy {

__device__ __forceinline__ u32 lo32(u64 x) { return static_cast<u32>(x); }
__device__ __forceinline__ u32 hi32(u64 x) { return static_cast<u32>(x >> 32); }
__device__ __forceinline__ u64 join(u32 lo, u32 hi) {
  return (static_cast<u64>(hi) << 32) | lo;
}

// Accumulators, little-endian 32-bit words.
struct Acc96 {
  u32 w0, w1, w2;
};
struct Acc128 {
  u32 w0, w1, w2, w3;
};

// a + b for words a, b: below 2^65.
__device__ __forceinline__ Acc96 sum(u64 a, u64 b) {
  Acc96 r;
  r.w0 = ptx::add_cc(lo32(a), lo32(b));
  r.w1 = ptx::addc_cc(hi32(a), hi32(b));
  r.w2 = ptx::addc(0u, 0u);
  return r;
}

// a + b; the caller keeps the sum below 2^96.
__device__ __forceinline__ Acc96 acc(const Acc96& a, const Acc96& b) {
  Acc96 r;
  r.w0 = ptx::add_cc(a.w0, b.w0);
  r.w1 = ptx::addc_cc(a.w1, b.w1);
  r.w2 = ptx::addc(a.w2, b.w2);
  return r;
}

// a + x for a word x; the caller keeps the sum below 2^96.
__device__ __forceinline__ Acc96 acc(const Acc96& a, u64 x) {
  Acc96 r;
  r.w0 = ptx::add_cc(a.w0, lo32(x));
  r.w1 = ptx::addc_cc(a.w1, hi32(x));
  r.w2 = ptx::addc(a.w2, 0u);
  return r;
}

// a·2^k for 0 < k < 32; the caller keeps a·2^k below 2^96.
template <int k>
__device__ __forceinline__ Acc96 shl(const Acc96& a) {
  return {a.w0 << k, (a.w1 << k) | (a.w0 >> (32 - k)), (a.w2 << k) | (a.w1 >> (32 - k))};
}

// a·b + c for words a, b and c < 2^96, below 2^128 whenever b is canonical:
// a·b <= (2^64 - 1)(p - 1) = 2^128 - 2^96 - 2^64 + 2^32.  Any other caller
// keeps a·b + c below 2^128 itself.
__device__ __forceinline__ Acc128 mul_add(u64 a, u64 b, const Acc96& c) {
  const u32 a0 = lo32(a), a1 = hi32(a), b0 = lo32(b), b1 = hi32(b);
  Acc128 r;
  // the even columns: a0·b0 at word 0, a1·b1 at word 2, with c on the chain
  r.w0 = ptx::mad_lo_cc(a0, b0, c.w0);
  r.w1 = ptx::madc_hi_cc(a0, b0, c.w1);
  r.w2 = ptx::madc_lo_cc(a1, b1, c.w2);
  r.w3 = ptx::madc_hi(a1, b1, 0u);
  // the odd column, a0·b1 + a1·b0 at word 1, one product at a time
  r.w1 = ptx::mad_lo_cc(a0, b1, r.w1);
  r.w2 = ptx::madc_hi_cc(a0, b1, r.w2);
  r.w3 = ptx::addc(r.w3, 0u);
  r.w1 = ptx::mad_lo_cc(a1, b0, r.w1);
  r.w2 = ptx::madc_hi_cc(a1, b0, r.w2);
  r.w3 = ptx::addc(r.w3, 0u);
  return r;
}

// a·b for words a, b: below (2^64 - 1)^2 < 2^128.
__device__ __forceinline__ Acc128 mul(u64 a, u64 b) {
  const u32 a0 = lo32(a), a1 = hi32(a), b0 = lo32(b), b1 = hi32(b);
  Acc128 r;
  r.w0 = ptx::mul_lo(a0, b0);
  r.w1 = ptx::mul_hi(a0, b0);
  r.w2 = ptx::mul_lo(a1, b1);
  r.w3 = ptx::mul_hi(a1, b1);
  r.w1 = ptx::mad_lo_cc(a0, b1, r.w1);
  r.w2 = ptx::madc_hi_cc(a0, b1, r.w2);
  r.w3 = ptx::addc(r.w3, 0u);
  r.w1 = ptx::mad_lo_cc(a1, b0, r.w1);
  r.w2 = ptx::madc_hi_cc(a1, b0, r.w2);
  r.w3 = ptx::addc(r.w3, 0u);
  return r;
}

// a^2 for a word a: the cross product once, added twice.
__device__ __forceinline__ Acc128 sqr(u64 a) {
  const u32 a0 = lo32(a), a1 = hi32(a);
  const u32 c0 = ptx::mul_lo(a0, a1), c1 = ptx::mul_hi(a0, a1);
  Acc128 r;
  r.w0 = ptx::mul_lo(a0, a0);
  r.w1 = ptx::mul_hi(a0, a0);
  r.w2 = ptx::mul_lo(a1, a1);
  r.w3 = ptx::mul_hi(a1, a1);
  r.w1 = ptx::add_cc(r.w1, c0);
  r.w2 = ptx::addc_cc(r.w2, c1);
  r.w3 = ptx::addc(r.w3, 0u);
  r.w1 = ptx::add_cc(r.w1, c0);
  r.w2 = ptx::addc_cc(r.w2, c1);
  r.w3 = ptx::addc(r.w3, 0u);
  return r;
}

// Any value below 2^128 to a word congruent to it.
//   (h:x0) + c·2^64 = (x1:x0) + x2·2^32, c the carry out of x1 + x2;
//   c·2^64 = c·2^32 - c, and (h:x0) + c·2^32 cannot pass 2^64 (c = 1 leaves
//   h <= 2^32 - 2), so the value is (h + c : x0) - d with d = x2 + x3 + c
//   below 2^33.  A borrow b out of that subtraction leaves r >= 2^64 - 2^33
//   + 1, from which b·(2^32 - 1) comes off without a second borrow: with
//   m = -b, r0 - m is r0 + b, and its borrow is b less the carry that
//   r0 + b would raise, which is all the high word still owes.
__device__ __forceinline__ u64 reduce(const Acc128& x) {
  u32 h = ptx::add_cc(x.w1, x.w2);
  h = ptx::addc(h, 0u);  // + c; the flag still holds c
  const u32 d0 = ptx::addc_cc(x.w2, x.w3);
  const u32 d1 = ptx::addc(0u, 0u);
  u32 r0 = ptx::sub_cc(x.w0, d0);
  u32 r1 = ptx::subc_cc(h, d1);
  const u32 m = ptx::subc(0u, 0u);  // 0, or all ones after a borrow
  r0 = ptx::sub_cc(r0, m);
  r1 = ptx::subc(r1, 0u);
  return join(r0, r1);
}

// Any value below 2^96 to a word congruent to it: (x1:x0) + x2·(2^32 - 1)
// is below 2^65; its carry c is worth 2^32 - 1 again, and when c = 1 what
// is left is at most 2^64 - 2^33, so adding it cannot carry.
__device__ __forceinline__ u64 reduce(const Acc96& x) {
  u32 r0 = ptx::mad_lo_cc(x.w2, 0xFFFFFFFFu, x.w0);
  u32 r1 = ptx::madc_hi_cc(x.w2, 0xFFFFFFFFu, x.w1);
  const u32 c = ptx::addc(0u, 0u);
  r0 = ptx::add_cc(r0, 0u - c);  // c·(2^32 - 1)
  r1 = ptx::addc(r1, 0u);
  return join(r0, r1);
}

// a + b for a word a and a canonical b (< p): a + b - 2^64 < p - 1 after a
// carry, so adding 2^32 - 1 for it cannot carry again.
__device__ __forceinline__ u64 add(u64 a, u64 b) {
  u32 r0 = ptx::add_cc(lo32(a), lo32(b));
  u32 r1 = ptx::addc_cc(hi32(a), hi32(b));
  const u32 c = ptx::addc(0u, 0u);
  r0 = ptx::add_cc(r0, 0u - c);
  r1 = ptx::addc(r1, 0u);
  return join(r0, r1);
}

// The canonical word of a lazy one: below 2^64 < 2p, so one subtraction.
__device__ __forceinline__ u64 canon(u64 x) { return x >= kP ? x - kP : x; }

}  // namespace lazy

}  // namespace gl
}  // namespace ezt
