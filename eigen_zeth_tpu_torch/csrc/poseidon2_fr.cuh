// Kernel F's core: Poseidon2 over BN254 Fr (t = 12, x^5, 4 + 68 + 4 rounds,
// M_E = circ(2·M4, M4, M4), M_I = 1 + diag(mu)) on lazily reduced
// Montgomery values, one thread a state.  Its entry points include it:
// poseidon2_fr.cu (the leaf sponge), poseidon2_fr_perm.cu (the permutation)
// and poseidon2_fr_tree.cu (the tree), through poseidon2_fr_launch.cuh.
//
// An element is eight 32-bit words, little end first, R = 2^256, and the
// modulus r is a compile-time constant (r_word, kN0: immediates of the
// multiply-adds, no kernel parameter).  r < 2^254 and R > 5.29·r: the
// words hold any representative below 2^256, and the core keeps each value
// in a stated range above r instead of reducing it to [0, r) after every
// operation.  Only `canon` (where a value leaves the kernel) returns a
// canonical value.  The ranges, with r+ = r + 2^232:
//
//   mont_mul(a, b)   a·b/R + m·r/R for the m that clears the low words:
//                    below a·b/R + r, with no final subtraction.  The CIOS
//                    rows keep the running value below (a + r)·2^32 before
//                    each shift, so nothing leaves the nine words of
//                    columns 0..8 while a + r <= 2^256 (`a`, the operand
//                    whose words multiply each word of b, below 4.29·r; b
//                    any 256-bit value).
//   mont_sqr(a)      the same bits' class, below a^2/R + r, for
//                    a <= 2^256 - r (then a^2 + m·r < 2^512).
//   reduce(v)        v below 2^262 in nine words -> below r+: the quotient
//                    q = floor(floor(v / 2^230)·floor(2^285 / r) / 2^55)
//                    is at most v/r and more than v/r - 1 - v/2^285 -
//                    2^230/r, so v - q·r lies in [0, r + 2^231.4).  The
//                    subtraction is v + q·(2^256 - r) mod 2^256: one
//                    32-bit product for q and eight multiply-adds.
//   mul_const_add    t + x·w for a constant w < r (the diagonal mu_i), any
//   (x, w, t)        x: Shoup's product, below t + 3r (see the function).
//   external(s)      M_E on any lanes below 2^256: each output lane is a
//                    sum with coefficients adding up to at most 64, so
//                    below 2^262 in nine words, then reduce: below r+.
//
// Through a permutation (the bounds, in multiples of r, come from the
// python model in tests/test_torch_poseidon2_fr_host_build.py, which
// asserts each of them):
//
//   entry            any lanes below 2^256; the first M_E takes them to r+.
//   full round       s + rc < r+ + r (3.62·r after the partial rounds);
//                    x^2 = sqr(x), x^4 = sqr(x^2), x^5 = mont_mul(x^4, x),
//                    each below 3.47·r and every operand <= 2^256 - r
//                    (4.29·r), x^5 below 3.24·r; M_E (sums below 64·3.24·r
//                    < 2^262) and reduce: r+.
//   partial round    lane 0 + rc and its S-box as above; tot = the twelve
//                    lanes in nine words (below 48·r), reduced once to T <
//                    r+; lane 0 becomes T + mont_mul(mu_0, x^5) (mu_0 < r the
//                    row operand: below 2.62·r, the fixed point of r+ +
//                    0.19·(lane 0 + r)^5-bound + r), lanes 1..11 become
//                    mul_const_add(s_i, mu_i, T), below r+ + 3r < 2^256:
//                    no reduction per add and none per lane.
//   after the 68     lanes 1..11 reduced once each (below r+), so the full
//   partial rounds   rounds' operands stay <= 2^256 - r.
//   exit             lanes below r+; from Montgomery form (a product by 1,
//                    at most r) and `canon` where a value leaves.
//
// A permutation on this core is 328 squarings of 108 multiply-adds, 232
// Montgomery products of 136 and 748 Shoup products of 115 (the diagonal of
// lanes 1..11): 152,996 multiply-adds on the integer multiply pipe, each a
// `mad.lo.cc` / `madc.hi.cc` pair that the assembler makes one wide
// multiply-add with carry in and out (IMAD.WIDE.U32.X).

// The header also compiles with a host C++ compiler: the PTX carry-flag
// operations are then emulated, and the emulation refuses a chain that
// hands an addition's carry to a subtraction or the reverse (such chains
// computed wrong words on the H100; csrc/goldilocks.cuh).

#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define EZT_FR_HD __host__ __device__
#else
#define __device__
#define __forceinline__ inline
#define EZT_FR_HD
#endif

namespace ezt {
namespace fr {

typedef uint32_t u32;
typedef uint64_t u64;

constexpr int kWords = 8;
constexpr int kWidth = 12;
constexpr int kRate = 11;
constexpr int kFull = 8;
constexpr int kHalf = kFull / 2;
constexpr int kPartial = 68;

// r, the BN254 scalar field's modulus, word j; n0 = -r^-1 mod 2^32.  Words
// of constants are functions, not arrays: device code may read a constexpr
// scalar, and a call with a constant j folds to an immediate operand.
EZT_FR_HD constexpr u32 r_word(int j) {
  return j == 0 ? 0xF0000001u : j == 1 ? 0x43E1F593u : j == 2 ? 0x79B97091u :
         j == 3 ? 0x2833E848u : j == 4 ? 0x8181585Du : j == 5 ? 0xB85045B6u :
         j == 6 ? 0xE131A029u : 0x30644E72u;
}
constexpr u32 kN0 = 0xEFFFFFFFu;
// 2^256 - r, and floor(2^285 / r), for `reduce`
EZT_FR_HD constexpr u32 neg_r_word(int j) {
  return j == 0 ? 0x0FFFFFFFu : j == 1 ? 0xBC1E0A6Cu : j == 2 ? 0x86468F6Eu :
         j == 3 ? 0xD7CC17B7u : j == 4 ? 0x7E7EA7A2u : j == 5 ? 0x47AFBA49u :
         j == 6 ? 0x1ECE5FD6u : 0xCF9BB18Du;
}
constexpr u32 kQuot = 0xA948E8C4u;

struct Fe {
  u32 w[kWords];
};

// A sum of lanes in nine words (column 8 the ninth).
struct Wide {
  u32 w[kWords + 1];
};

// The instance's constants, in Montgomery form where not marked, in the
// order of the host array `kernels.poseidon_fr_const_words()`.
struct Consts {
  Fe rc_full[kFull][kWidth];
  Fe rc_part[kPartial];
  Fe mu[kWidth];
  Fe r2;  // R^2 mod r: a product by it takes a regular value into Montgomery form
  Fe mu_plain[kWidth];  // mu_i itself, for `mul_const_add`
  Fe mu_quot[kWidth];   // floor(mu_i·2^256 / r)
};

// ---------------------------------------------------------------------------
// PTX with the carry flag.  Each operation is its own `asm volatile`
// statement: volatile statements keep their order, and the compiler emits
// nothing of its own that writes the flag, so the flag set by one statement
// reaches the next.  A flag set by an addition is read only by an addition,
// one set by a subtraction only by a subtraction.

namespace ptx {

#if defined(__CUDACC__)

#define EZT_FR_ASM3(name, op)                                                \
  __device__ __forceinline__ u32 name(u32 a, u32 b, u32 c) {                 \
    u32 r;                                                                   \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));  \
    return r;                                                                \
  }
#define EZT_FR_ASM2(name, op)                                        \
  __device__ __forceinline__ u32 name(u32 a, u32 b) {                \
    u32 r;                                                           \
    asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));      \
    return r;                                                        \
  }

EZT_FR_ASM3(mad_lo_cc, "mad.lo.cc.u32")    // lo(a·b) + c, sets the flag
EZT_FR_ASM3(madc_lo_cc, "madc.lo.cc.u32")  // lo(a·b) + c + flag, sets it
EZT_FR_ASM3(madc_hi_cc, "madc.hi.cc.u32")  // hi(a·b) + c + flag, sets it
EZT_FR_ASM3(madc_lo, "madc.lo.u32")        // lo(a·b) + c + flag
EZT_FR_ASM3(madc_hi, "madc.hi.u32")        // hi(a·b) + c + flag
EZT_FR_ASM2(add_cc, "add.cc.u32")
EZT_FR_ASM2(addc_cc, "addc.cc.u32")
EZT_FR_ASM2(addc, "addc.u32")  // reads the flag, leaves it as it was
EZT_FR_ASM2(sub_cc, "sub.cc.u32")  // the flag is the borrow
EZT_FR_ASM2(subc_cc, "subc.cc.u32")
EZT_FR_ASM2(subc, "subc.u32")

#undef EZT_FR_ASM3
#undef EZT_FR_ASM2

__device__ __forceinline__ u32 mul_hi(u32 a, u32 b) { return __umulhi(a, b); }

// v, hidden from the optimiser: a round loop whose count it cannot see is
// not unrolled (eight copies of a full round made the code 2.5 times larger
// and took minutes to compile).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

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
inline u32 carry() {
  if (flag().kind != '+') throw "an addition reads a flag no addition set";
  return flag().bit;
}
inline u32 borrow() {
  if (flag().kind != '-') throw "a subtraction reads a flag no subtraction set";
  return flag().bit;
}
inline u64 prod(u32 a, u32 b) { return static_cast<u64>(a) * b; }
inline u32 lo(u32 a, u32 b) { return static_cast<u32>(prod(a, b)); }
inline u32 mul_hi(u32 a, u32 b) { return static_cast<u32>(prod(a, b) >> 32); }
inline u32 mad_lo_cc(u32 a, u32 b, u32 c) { return set(u64{lo(a, b)} + c, '+'); }
inline u32 madc_lo_cc(u32 a, u32 b, u32 c) { return set(u64{lo(a, b)} + c + carry(), '+'); }
inline u32 madc_hi_cc(u32 a, u32 b, u32 c) { return set(u64{mul_hi(a, b)} + c + carry(), '+'); }
inline u32 madc_lo(u32 a, u32 b, u32 c) { return lo(a, b) + c + carry(); }
inline u32 madc_hi(u32 a, u32 b, u32 c) { return mul_hi(a, b) + c + carry(); }
inline u32 add_cc(u32 a, u32 b) { return set(u64{a} + b, '+'); }
inline u32 addc_cc(u32 a, u32 b) { return set(u64{a} + b + carry(), '+'); }
inline u32 addc(u32 a, u32 b) { return a + b + carry(); }
inline u32 sub_cc(u32 a, u32 b) { return set(u64{a} - b, '-'); }
inline u32 subc_cc(u32 a, u32 b) { return set(u64{a} - b - borrow(), '-'); }
inline u32 subc(u32 a, u32 b) { return a - b - borrow(); }
inline int opaque(int v) { return v; }

#endif

}  // namespace ptx

using namespace ptx;

// ---------------------------------------------------------------------------
// adds

// a + b; the caller keeps the sum below 2^256.
__device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
  Fe s;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) s.w[k] = addc_cc(a.w[k], b.w[k]);
  s.w[kWords - 1] = addc(a.w[kWords - 1], b.w[kWords - 1]);
  return s;
}

// a + b in nine words.
__device__ __forceinline__ Wide sum(const Fe& a, const Fe& b) {
  Wide s;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < kWords; ++k) s.w[k] = addc_cc(a.w[k], b.w[k]);
  s.w[kWords] = addc(0u, 0u);
  return s;
}

// a + b; the caller keeps the sum below 2^288.
__device__ __forceinline__ Wide add(const Wide& a, const Wide& b) {
  Wide s;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < kWords; ++k) s.w[k] = addc_cc(a.w[k], b.w[k]);
  s.w[kWords] = addc(a.w[kWords], b.w[kWords]);
  return s;
}

__device__ __forceinline__ Wide add(const Wide& a, const Fe& b) {
  Wide s;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < kWords; ++k) s.w[k] = addc_cc(a.w[k], b.w[k]);
  s.w[kWords] = addc(a.w[kWords], 0u);
  return s;
}

// a·4; the caller keeps it below 2^288.
__device__ __forceinline__ Wide times4(const Wide& a) {
  Wide s;
  s.w[0] = a.w[0] << 2;
#pragma unroll
  for (int k = 1; k <= kWords; ++k) s.w[k] = (a.w[k] << 2) | (a.w[k - 1] >> 30);
  return s;
}

// v mod r for v below 2^262, as a value below r+ = r + 2^232 (see the top).
__device__ __forceinline__ Fe reduce(const Wide& v) {
  const u32 top = (v.w[kWords] << 26) | (v.w[kWords - 1] >> 6);  // floor(v / 2^230)
  const u32 q = mul_hi(top, kQuot) >> 23;
  Fe s;  // v + q·(2^256 - r) mod 2^256: the even words' products, then the odd ones'
  s.w[0] = mad_lo_cc(q, neg_r_word(0), v.w[0]);
  s.w[1] = madc_hi_cc(q, neg_r_word(0), v.w[1]);
#pragma unroll
  for (int k = 2; k < kWords - 2; k += 2) {
    s.w[k] = madc_lo_cc(q, neg_r_word(k), v.w[k]);
    s.w[k + 1] = madc_hi_cc(q, neg_r_word(k), v.w[k + 1]);
  }
  s.w[6] = madc_lo_cc(q, neg_r_word(6), v.w[6]);
  s.w[7] = madc_hi(q, neg_r_word(6), v.w[7]);
  s.w[1] = mad_lo_cc(q, neg_r_word(1), s.w[1]);
  s.w[2] = madc_hi_cc(q, neg_r_word(1), s.w[2]);
#pragma unroll
  for (int k = 3; k < kWords - 1; k += 2) {
    s.w[k] = madc_lo_cc(q, neg_r_word(k), s.w[k]);
    s.w[k + 1] = madc_hi_cc(q, neg_r_word(k), s.w[k + 1]);
  }
  s.w[7] = madc_lo(q, neg_r_word(7), s.w[7]);
  return s;
}

// a - r where that is >= 0, else a: canonical for a < 2r.
__device__ __forceinline__ Fe canon(const Fe& a) {
  Fe d;
  d.w[0] = sub_cc(a.w[0], r_word(0));
#pragma unroll
  for (int k = 1; k < kWords; ++k) d.w[k] = subc_cc(a.w[k], r_word(k));
  const u32 borrow = subc(0u, 0u);
#pragma unroll
  for (int k = 0; k < kWords; ++k) d.w[k] = borrow ? a.w[k] : d.w[k];
  return d;
}

// ---------------------------------------------------------------------------
// Montgomery product and square (the schedule of bn254_field.cuh, without
// the final subtraction, on the constant modulus)

// T += r·mi with mi = E[0]·n0, which clears column 0.  E: columns 0..7, O:
// columns 1..8; the carry out of E's chain lands in O[7] (column 8).
__device__ __forceinline__ void reduce_row(u32 (&E)[kWords], u32 (&O)[kWords]) {
  const u32 mi = E[0] * kN0;
  E[0] = mad_lo_cc(r_word(0), mi, E[0]);
  E[1] = madc_hi_cc(r_word(0), mi, E[1]);
#pragma unroll
  for (int j = 2; j < kWords; j += 2) {
    E[j] = madc_lo_cc(r_word(j), mi, E[j]);
    E[j + 1] = madc_hi_cc(r_word(j), mi, E[j + 1]);
  }
  O[7] = addc(O[7], 0u);
  O[0] = mad_lo_cc(r_word(1), mi, O[0]);
  O[1] = madc_hi_cc(r_word(1), mi, O[1]);
#pragma unroll
  for (int j = 2; j < kWords - 2; j += 2) {
    O[j] = madc_lo_cc(r_word(j + 1), mi, O[j]);
    O[j + 1] = madc_hi_cc(r_word(j + 1), mi, O[j + 1]);
  }
  O[6] = madc_lo_cc(r_word(7), mi, O[6]);
  O[7] = madc_hi(r_word(7), mi, O[7]);
}

// Drop column 0 (E[0] == 0 after reduce_row) and add a·b one column down:
// O becomes the new even array (columns 0..7) and E the new odd one.
__device__ __forceinline__ void shift_mul_row(u32 (&E)[kWords], u32 (&O)[kWords], const Fe& a,
                                              u32 b) {
  O[0] = add_cc(O[0], E[1]);
#pragma unroll
  for (int j = 0; j < kWords - 2; j += 2) {
    E[j] = madc_lo_cc(a.w[j + 1], b, E[j + 2]);
    E[j + 1] = madc_hi_cc(a.w[j + 1], b, E[j + 3]);
  }
  E[6] = madc_lo_cc(a.w[7], b, 0u);
  E[7] = madc_hi(a.w[7], b, 0u);
  O[0] = mad_lo_cc(a.w[0], b, O[0]);
  O[1] = madc_hi_cc(a.w[0], b, O[1]);
#pragma unroll
  for (int j = 2; j < kWords; j += 2) {
    O[j] = madc_lo_cc(a.w[j], b, O[j]);
    O[j + 1] = madc_hi_cc(a.w[j], b, O[j + 1]);
  }
  E[7] = addc(E[7], 0u);
}

// a·b·2^-256 mod r, below a·b/R + r, for a <= 2^256 - r and any b.
__device__ __forceinline__ Fe mont_mul(const Fe& a, const Fe& b) {
  u32 e[kWords], o[kWords];
#pragma unroll
  for (int j = 0; j < kWords; j += 2) {
    e[j] = (j == 0) ? mad_lo_cc(a.w[j], b.w[0], 0u) : madc_lo_cc(a.w[j], b.w[0], 0u);
    e[j + 1] = madc_hi_cc(a.w[j], b.w[0], 0u);
  }
#pragma unroll
  for (int j = 0; j < kWords; j += 2) {
    o[j] = (j == 0) ? mad_lo_cc(a.w[j + 1], b.w[0], 0u) : madc_lo_cc(a.w[j + 1], b.w[0], 0u);
    o[j + 1] = madc_hi_cc(a.w[j + 1], b.w[0], 0u);
  }
  reduce_row(e, o);
#pragma unroll
  for (int i = 1; i < kWords; i += 2) {
    shift_mul_row(e, o, a, b.w[i]);
    reduce_row(o, e);
    if (i + 1 < kWords) {
      shift_mul_row(o, e, a, b.w[i + 1]);
      reduce_row(e, o);
    }
  }
  // o is the even array now, e the odd one: drop column 0 and merge
  Fe s;
  s.w[0] = add_cc(e[0], o[1]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) s.w[k] = addc_cc(e[k], o[k + 1]);
  s.w[kWords - 1] = addc(e[kWords - 1], 0u);
  return s;
}

// Montgomery reduction t·2^-256 mod r of a 16-word t with t + r·2^256 <
// 2^512: below t/R + r.  Round i clears word i; the carries out of its two
// chains (columns i+8 and i+9) wait in `cw` and are added once at the end.
__device__ __forceinline__ Fe reduce_wide(u32 (&t)[2 * kWords]) {
  u32 cw[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) cw[k] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const u32 mi = t[i] * kN0;
    t[i] = mad_lo_cc(r_word(0), mi, t[i]);
    t[i + 1] = madc_hi_cc(r_word(0), mi, t[i + 1]);
#pragma unroll
    for (int j = 2; j < kWords; j += 2) {
      t[i + j] = madc_lo_cc(r_word(j), mi, t[i + j]);
      t[i + j + 1] = madc_hi_cc(r_word(j), mi, t[i + j + 1]);
    }
    cw[i] = addc(cw[i], 0u);
    t[i + 1] = mad_lo_cc(r_word(1), mi, t[i + 1]);
    t[i + 2] = madc_hi_cc(r_word(1), mi, t[i + 2]);
#pragma unroll
    for (int j = 3; j < kWords - 1; j += 2) {
      t[i + j] = madc_lo_cc(r_word(j), mi, t[i + j]);
      t[i + j + 1] = madc_hi_cc(r_word(j), mi, t[i + j + 1]);
    }
    t[i + 7] = madc_lo_cc(r_word(7), mi, t[i + 7]);
    if (i < kWords - 1) {
      t[i + 8] = madc_hi_cc(r_word(7), mi, t[i + 8]);
      cw[i + 1] = addc(cw[i + 1], 0u);
    } else {
      t[15] = madc_hi(r_word(7), mi, t[15]);  // the total is below 2^512
    }
  }
  Fe s;
  s.w[0] = add_cc(t[kWords], cw[0]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) s.w[k] = addc_cc(t[kWords + k], cw[k]);
  s.w[kWords - 1] = addc(t[2 * kWords - 1], cw[kWords - 1]);
  return s;
}

// a·a·2^-256 mod r, below a^2/R + r, for a <= 2^256 - r: the 28 cross
// products once, in two arrays by the parity of their column so that each
// row runs two chains, merged, doubled, the 8 diagonal squares added, then
// reduced.
__device__ __forceinline__ Fe mont_sqr(const Fe& a) {
  u32 te[2 * kWords], to[2 * kWords];
#pragma unroll
  for (int k = 0; k < 2 * kWords; ++k) te[k] = to[k] = 0;
#pragma unroll
  for (int i = 0; i < kWords - 1; ++i) {
    // i + j odd: columns i+j, i+j+1 are to[i+j-1], to[i+j].  After row i the
    // sum fits columns 0..i+8, so a chain that ends below the top column
    // hands its carry to the next word, and one that ends on it has none.
    int last = 0;
#pragma unroll
    for (int j = i + 1; j < kWords; j += 2) {
      const int c = i + j;
      to[c - 1] = (j == i + 1) ? mad_lo_cc(a.w[i], a.w[j], to[c - 1])
                               : madc_lo_cc(a.w[i], a.w[j], to[c - 1]);
      last = c;
      to[c] = (last == i + 7) ? madc_hi(a.w[i], a.w[j], to[c])
                              : madc_hi_cc(a.w[i], a.w[j], to[c]);
    }
    if (last != i + 7) to[last + 1] = addc(to[last + 1], 0u);
    // i + j even: columns i+j, i+j+1 are te[i+j], te[i+j+1]
    last = 0;
#pragma unroll
    for (int j = i + 2; j < kWords; j += 2) {
      const int c = i + j;
      te[c] = (j == i + 2) ? mad_lo_cc(a.w[i], a.w[j], te[c])
                           : madc_lo_cc(a.w[i], a.w[j], te[c]);
      last = c + 1;
      te[c + 1] = (last == i + 8) ? madc_hi(a.w[i], a.w[j], te[c + 1])
                                  : madc_hi_cc(a.w[i], a.w[j], te[c + 1]);
    }
    if (last != 0 && last != i + 8) te[last + 1] = addc(te[last + 1], 0u);
  }
  u32 t[2 * kWords];
  t[0] = 0;  // no cross product reaches column 0
  t[1] = add_cc(te[1], to[0]);
#pragma unroll
  for (int k = 2; k < 2 * kWords - 1; ++k) t[k] = addc_cc(te[k], to[k - 1]);
  t[15] = addc(te[15], to[14]);
  t[1] = add_cc(t[1], t[1]);
#pragma unroll
  for (int k = 2; k < 2 * kWords - 1; ++k) t[k] = addc_cc(t[k], t[k]);
  t[15] = addc(t[15], t[15]);
  t[0] = mad_lo_cc(a.w[0], a.w[0], 0u);
  t[1] = madc_hi_cc(a.w[0], a.w[0], t[1]);
#pragma unroll
  for (int i = 1; i < kWords - 1; ++i) {
    t[2 * i] = madc_lo_cc(a.w[i], a.w[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a.w[i], a.w[i], t[2 * i + 1]);
  }
  t[14] = madc_lo_cc(a.w[7], a.w[7], t[14]);
  t[15] = madc_hi(a.w[7], a.w[7], t[15]);
  return reduce_wide(t);
}

// t + x·w mod r for a constant w < r, below t + 3r, for any x: Shoup's
// product with the precomputed w' = floor(w·2^256 / r).  The quotient
// q = floor(x·w' / 2^256) comes from the columns 6..15 of x·w' alone (43
// multiply-adds: the columns below add less than 6·2^224, so q is at most
// one short), and t + x·w - q·r is taken mod 2^256 from the low columns of
// x·w and q·(2^256 - r) (36 multiply-adds each, t the accumulator's start):
// 0 <= x·w - q·r < 3r, because the exact quotient is at most x·w/r and
// more than x·w/r - x/2^256 - 1 > x·w/r - 2.  115 multiply-adds for the
// Montgomery product's 136, and the add of t free.
// Montgomery form is kept: (xR)·w = (x·w)R.
//
// One chain of a schoolbook row into the accumulator `acc` (index = column
// - kLo): u times the constant's words v(j) for j = j0, j0 + 2, .. <= j1,
// each a pair (i + j, i + j + 1).  `kTop` is the highest column kept: a pair
// that reaches it ends the chain with no carry out, a pair that starts on
// it keeps its low word alone (the high one falls off), and a chain that
// ends below it hands its carry to the word above, which no earlier row
// has reached.
template <int kLo, int kTop, int kCols, class V>
__device__ __forceinline__ void chain(u32 (&acc)[kCols], u32 u, int i, int j0, int j1, V v) {
  int last = -1;
#pragma unroll
  for (int j = j0; j <= j1; j += 2) {
    const int c = i + j - kLo;
    const bool first = j == j0;
    if (c + kLo == kTop) {  // the low word only
      acc[c] = first ? acc[c] + u * v(j) : madc_lo(u, v(j), acc[c]);
      last = kTop + 1;
    } else {
      acc[c] = first ? mad_lo_cc(u, v(j), acc[c]) : madc_lo_cc(u, v(j), acc[c]);
      acc[c + 1] = (c + 1 + kLo == kTop) ? madc_hi(u, v(j), acc[c + 1])
                                         : madc_hi_cc(u, v(j), acc[c + 1]);
      last = c + 1 + kLo;
    }
  }
  if (last >= 0 && last < kTop) acc[last + 1 - kLo] = addc(acc[last + 1 - kLo], 0u);
}

// A row's two chains, into E (pairs from an even column) and O (from an
// odd one), as in mont_mul: two carry chains in flight.
template <int kLo, int kTop, int kCols, class V>
__device__ __forceinline__ void row(u32 (&E)[kCols], u32 (&O)[kCols], u32 u, int i, int j0,
                                    int j1, V v) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if ((i + j0 + k) & 1)
      chain<kLo, kTop>(O, u, i, j0 + k, j1, v);
    else
      chain<kLo, kTop>(E, u, i, j0 + k, j1, v);
  }
}

template <class W, class Q>
__device__ __forceinline__ Fe mul_const_add(const Fe& x, W w, Q wq, const Fe& t) {
  // q: columns 6..15 of x·w', index c - 6
  u32 he[10], ho[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) he[k] = ho[k] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int j0 = i < 6 ? 6 - i : 0;
    row<6, 15>(he, ho, x.w[i], i, j0, kWords - 1, wq);
  }
  Fe q;  // (he + ho) / 2^256: columns 8..15, after column 7's carry
  add_cc(he[1], ho[1]);
#pragma unroll
  for (int k = 0; k < kWords - 1; ++k) q.w[k] = addc_cc(he[2 + k], ho[2 + k]);
  q.w[kWords - 1] = addc(he[9], ho[9]);
  // t + x·w + q·(2^256 - r) mod 2^256: columns 0..7
  u32 le[kWords], lo[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    le[k] = t.w[k];
    lo[k] = 0;
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) row<0, 7>(le, lo, x.w[i], i, 0, kWords - 1 - i, w);
#pragma unroll
  for (int i = 0; i < kWords; ++i)
    row<0, 7>(le, lo, q.w[i], i, 0, kWords - 1 - i, [](int j) { return neg_r_word(j); });
  Fe y;
  y.w[0] = le[0];
  y.w[1] = add_cc(le[1], lo[1]);
#pragma unroll
  for (int k = 2; k < kWords - 1; ++k) y.w[k] = addc_cc(le[k], lo[k]);
  y.w[kWords - 1] = addc(le[kWords - 1], lo[kWords - 1]);
  return y;
}

// ---------------------------------------------------------------------------
// the permutation

__device__ __forceinline__ Fe sbox(const Fe& x) {
  const Fe x2 = mont_sqr(x);
  const Fe x4 = mont_sqr(x2);
  return mont_mul(x4, x);
}

// M4 of one block (coefficient rows 5 7 1 3 / 4 6 1 1 / 1 3 5 7 / 1 1 4 6),
// in nine words: each output below 16·2^256.
__device__ __forceinline__ void m4(const Fe& x0, const Fe& x1, const Fe& x2, const Fe& x3,
                                   Wide (&o)[4]) {
  const Wide t0 = sum(x0, x1);
  const Wide t1 = sum(x2, x3);
  const Wide t2 = add(sum(x1, x1), t1);
  const Wide t3 = add(sum(x3, x3), t0);
  const Wide t4 = add(times4(t1), t3);
  const Wide t5 = add(times4(t0), t2);
  o[0] = add(t3, t5);
  o[1] = t5;
  o[2] = add(t2, t4);
  o[3] = t4;
}

// M_E: the three M4 blocks, then each lane plus its column's sum over the
// blocks, reduced once: lanes below 2^256 in, below r+ out.
__device__ __forceinline__ void external(Fe (&s)[kWidth]) {
  Wide o[3][4];
#pragma unroll
  for (int b = 0; b < 3; ++b) m4(s[4 * b], s[4 * b + 1], s[4 * b + 2], s[4 * b + 3], o[b]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Wide col = add(add(o[0][j], o[1][j]), o[2][j]);
#pragma unroll
    for (int b = 0; b < 3; ++b) s[4 * b + j] = reduce(add(o[b][j], col));
  }
}

__device__ __forceinline__ void full_round(Fe (&s)[kWidth], const Fe (&rc)[kWidth]) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = sbox(add(s[i], rc[i]));
  external(s);
}

__device__ __forceinline__ void partial_round(Fe (&s)[kWidth], const Fe& rc, const Consts& c) {
  s[0] = sbox(add(s[0], rc));
  Wide tot = sum(s[0], s[1]);
#pragma unroll
  for (int i = 2; i < kWidth; ++i) tot = add(tot, s[i]);
  const Fe t = reduce(tot);
  s[0] = add(t, mont_mul(c.mu[0], s[0]));
#pragma unroll
  for (int i = 1; i < kWidth; ++i)
    s[i] = mul_const_add(s[i], [&](int j) { return c.mu_plain[i].w[j]; },
                         [&](int j) { return c.mu_quot[i].w[j]; }, t);
}

__device__ __forceinline__ Fe widen_reduce(const Fe& a) {
  Wide v;
#pragma unroll
  for (int k = 0; k < kWords; ++k) v.w[k] = a.w[k];
  v.w[kWords] = 0;
  return reduce(v);
}

// The permutation of a Montgomery-form state: lanes below 2^256 in, below
// r+ out, each lane congruent to the JAX package's `perm_host` lane times R.
__device__ __forceinline__ void permute(Fe (&s)[kWidth], const Consts& c) {
  const int half = opaque(kHalf), partial = opaque(kPartial);
  external(s);
#pragma unroll 1
  for (int r = 0; r < half; ++r) full_round(s, c.rc_full[r]);
#pragma unroll 1
  for (int r = 0; r < partial; ++r) partial_round(s, c.rc_part[r], c);
#pragma unroll
  for (int i = 1; i < kWidth; ++i) s[i] = widen_reduce(s[i]);
#pragma unroll 1
  for (int r = half; r < 2 * half; ++r) full_round(s, c.rc_full[r]);
}

// ---------------------------------------------------------------------------
// the boundary: regular canonical values in, out

// Montgomery form of a regular value below 2^256: below 2r.
__device__ __forceinline__ Fe to_mont(const Fe& x, const Consts& c) { return mont_mul(c.r2, x); }

// The canonical regular value of x below 2^256: a product by 1 is at most r.
__device__ __forceinline__ Fe from_mont(const Fe& x) {
  Fe one;
#pragma unroll
  for (int k = 0; k < kWords; ++k) one.w[k] = 0;
  one.w[0] = 1;
  return canon(mont_mul(one, x));
}

__device__ __forceinline__ Fe zero() {
  Fe z;
#pragma unroll
  for (int k = 0; k < kWords; ++k) z.w[k] = 0;
  return z;
}

// Packed sponge input e of a row: its Goldilocks values 3e, 3e+1, 3e+2 (those
// below k) in words 0..5, already read into v[0..2].
__device__ __forceinline__ Fe pack3(u64 v0, u64 v1, u64 v2) {
  Fe x;
  x.w[0] = static_cast<u32>(v0);
  x.w[1] = static_cast<u32>(v0 >> 32);
  x.w[2] = static_cast<u32>(v1);
  x.w[3] = static_cast<u32>(v1 >> 32);
  x.w[4] = static_cast<u32>(v2);
  x.w[5] = static_cast<u32>(v2 >> 32);
  x.w[6] = x.w[7] = 0;
  return x;
}

}  // namespace fr
}  // namespace ezt
