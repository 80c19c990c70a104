// Montgomery field arithmetic for the BN254 kernels, one element per thread.
//
// Counterpart of `_field_ops` in eigen_zeth_tpu/ops/pallas/ec_pl.py:29
// (mont_mul, add, sub, dbl, is_zero, select), plus what the kernels share
// beyond it: neg, a dedicated squaring, the unsafe mixed add, and Fq2 =
// Fq[u]/(u^2 + 1) for the G2 point add.  The TPU kernels hold an element as
// 16 limbs of 16 bits in uint32 lanes because the VPU has no wide
// multiplier; here an element lives in eight 32-bit registers.  R stays
// 2^256, so the Montgomery form, and every output bit, is the same as the
// JAX package's.
//
// What bounds a product on the H100: the integer multiply pipe.  A
// Montgomery product is 136 32x32->64 multiply-adds (64 for a*b, 64 for m*q,
// 8 for the m's), each fed a carry by the one before it, so a single chain
// leaves the pipe idle for most of its latency.  The design:
//
//   * every multiply-add is a `mad.lo.cc` / `madc.hi.cc` pair on the same
//     operands and neighbouring accumulator words, which the assembler
//     turns into one wide multiply-add with carry in and out
//     (IMAD.WIDE.U32.X): of the 128 products of a compiled Montgomery
//     product 121 are such wide multiply-adds, beside about 125
//     three-input adds that move the carries between the halves
//     (scripts/sass_histogram.py on sm_90a);
//   * the accumulator is split by column parity: `E` holds the products
//     a[0], a[2], a[4], a[6] times b_i (columns 0..7) and `O` those of a[1],
//     a[3], a[5], a[7] (columns 1..8).  The two carry chains of a row do not
//     touch each other's words, so two are in flight per thread;
//   * the word shift of each CIOS round costs nothing: E and O swap roles,
//     and the one word that changes column is folded into the next row's
//     chain as its addend;
//   * a squaring computes the 28 cross products once, doubles them, adds
//     the 8 diagonal squares and reduces the 16-word result: 108
//     multiply-adds for 136;
//   * an Fq2 element lives on two neighbouring lanes of a warp, one
//     component each (`Fq2Lanes`): an Fq2 product is, on each lane, a sum of
//     two products and ONE reduction (`mont_mul2_lanes`), the partner's
//     words arriving by shuffle.
//
// The probe in imad_probe.cu puts numbers to it (chip_smoke.py prints them):
// an H100 at 700 W ran bare wide multiply-adds at 10.1 T/s and chains of
// these products at 8.2 T multiply-adds/s.
//
// No chain can overflow its top word as long as q < 2^255: with a, b < q
// the running value stays below 2q, and a row adds less than 2^33 q, so
// everything fits columns 0..8.  The wrappers refuse a wider modulus.
//
// Each PTX operation is its own `asm volatile` statement: volatile
// statements keep their order, and the compiler itself emits nothing that
// writes the carry flag, so the flag set by one statement reaches the next.
//
// Memory layout at the kernel boundary is the package's public one: a batch
// of B elements is a limb-major (16, B) int32 tensor of 16-bit limbs, so
// thread i reads limb k at k*B + i and neighbouring threads touch
// neighbouring addresses (coalesced).  Outputs are canonical (< q).

#pragma once

#include <cstdint>
#include <cstring>

namespace ezt {

constexpr int kWords = 8;  // 32-bit words per element: R = 2^256
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// The modulus travels by value in the kernel's parameter space, so every
// q[j] read below is a constant-bank operand of the multiply.
struct Modulus {
  uint32_t q[kWords];
  uint32_t n0;  // -q^{-1} mod 2^32
};

inline Modulus make_modulus(const void* q_words, unsigned n0) {
  Modulus m;
  std::memcpy(m.q, q_words, sizeof(m.q));
  m.n0 = n0;
  return m;
}

struct Fe {
  uint32_t w[kWords];
};

// ---------------------------------------------------------------------------
// PTX with the carry flag

#define EZT_ASM3(name, ptx)                                                  \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,           \
                                           uint32_t c) {                     \
    uint32_t r;                                                              \
    asm volatile(ptx " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
    return r;                                                                \
  }
#define EZT_ASM2(name, ptx)                                          \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) { \
    uint32_t r;                                                      \
    asm volatile(ptx " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));     \
    return r;                                                        \
  }

EZT_ASM3(mad_lo_cc, "mad.lo.cc.u32")    // lo(a*b) + c, sets carry
EZT_ASM3(madc_lo_cc, "madc.lo.cc.u32")  // lo(a*b) + c + carry, sets carry
EZT_ASM3(madc_hi_cc, "madc.hi.cc.u32")  // hi(a*b) + c + carry, sets carry
EZT_ASM3(madc_hi, "madc.hi.u32")        // hi(a*b) + c + carry
EZT_ASM2(add_cc, "add.cc.u32")
EZT_ASM2(addc_cc, "addc.cc.u32")
EZT_ASM2(addc, "addc.u32")
EZT_ASM2(sub_cc, "sub.cc.u32")
EZT_ASM2(subc_cc, "subc.cc.u32")
EZT_ASM2(subc, "subc.u32")

#undef EZT_ASM3
#undef EZT_ASM2

// ---------------------------------------------------------------------------
// loads, stores, selects

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

// ---------------------------------------------------------------------------
// add, sub, neg

// a - q when that is >= 0, else a (input < 2q < 2^256).
__device__ __forceinline__ Fe cond_sub_q(const Fe& a, const Modulus& m) {
  Fe d;
  d.w[0] = sub_cc(a.w[0], m.q[0]);
#pragma unroll
  for (int k = 1; k < kWords; ++k) d.w[k] = subc_cc(a.w[k], m.q[k]);
  const uint32_t borrow = subc(0, 0);  // 0 or 0xFFFFFFFF
  return select_fe(borrow != 0, a, d);
}

__device__ __forceinline__ Fe add_fe(const Fe& a, const Fe& b,
                                     const Modulus& m) {
  Fe s;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) s.w[k] = addc_cc(a.w[k], b.w[k]);
  s.w[kWords - 1] = addc(a.w[kWords - 1], b.w[kWords - 1]);
  return cond_sub_q(s, m);
}

__device__ __forceinline__ Fe dbl_fe(const Fe& a, const Modulus& m) {
  return add_fe(a, a, m);
}

// a - b, adding q back on borrow.
__device__ __forceinline__ Fe sub_fe(const Fe& a, const Fe& b,
                                     const Modulus& m) {
  Fe d;
  d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < kWords; ++k) d.w[k] = subc_cc(a.w[k], b.w[k]);
  const uint32_t borrow = subc(0, 0);
  Fe e;
  e.w[0] = add_cc(d.w[0], m.q[0]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) e.w[k] = addc_cc(d.w[k], m.q[k]);
  e.w[kWords - 1] = addc(d.w[kWords - 1], m.q[kWords - 1]);
  return select_fe(borrow != 0, e, d);
}

// -a mod q, with -0 = 0, so the output stays canonical (q - 0 would be q).
__device__ __forceinline__ Fe neg_fe(const Fe& a, const Modulus& m) {
  Fe d;
  d.w[0] = sub_cc(m.q[0], a.w[0]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) d.w[k] = subc_cc(m.q[k], a.w[k]);
  d.w[kWords - 1] = subc(m.q[kWords - 1], a.w[kWords - 1]);
  return select_fe(is_zero_fe(a), a, d);
}

// ---------------------------------------------------------------------------
// Montgomery product

// T += q*mi with mi = E[0]*n0, which clears column 0.  E: columns 0..7, O:
// columns 1..8; the carry out of E's chain lands in O[7] (column 8).
__device__ __forceinline__ void reduce_row(uint32_t (&E)[kWords],
                                           uint32_t (&O)[kWords],
                                           const Modulus& m) {
  const uint32_t mi = E[0] * m.n0;
  E[0] = mad_lo_cc(m.q[0], mi, E[0]);
  E[1] = madc_hi_cc(m.q[0], mi, E[1]);
#pragma unroll
  for (int j = 2; j < kWords; j += 2) {
    E[j] = madc_lo_cc(m.q[j], mi, E[j]);
    E[j + 1] = madc_hi_cc(m.q[j], mi, E[j + 1]);
  }
  O[7] = addc(O[7], 0);
  O[0] = mad_lo_cc(m.q[1], mi, O[0]);
  O[1] = madc_hi_cc(m.q[1], mi, O[1]);
#pragma unroll
  for (int j = 2; j < kWords - 2; j += 2) {
    O[j] = madc_lo_cc(m.q[j + 1], mi, O[j]);
    O[j + 1] = madc_hi_cc(m.q[j + 1], mi, O[j + 1]);
  }
  O[6] = madc_lo_cc(m.q[7], mi, O[6]);
  O[7] = madc_hi(m.q[7], mi, O[7]);
}

// T += a*b in place, no shift: the same two chains as reduce_row with (a,
// b) for (q, mi).  E: columns 0..7, O: columns 1..8.
__device__ __forceinline__ void mul_row(uint32_t (&E)[kWords],
                                        uint32_t (&O)[kWords],
                                        const uint32_t (&a)[kWords],
                                        uint32_t b) {
  E[0] = mad_lo_cc(a[0], b, E[0]);
  E[1] = madc_hi_cc(a[0], b, E[1]);
#pragma unroll
  for (int j = 2; j < kWords; j += 2) {
    E[j] = madc_lo_cc(a[j], b, E[j]);
    E[j + 1] = madc_hi_cc(a[j], b, E[j + 1]);
  }
  O[7] = addc(O[7], 0);
  O[0] = mad_lo_cc(a[1], b, O[0]);
  O[1] = madc_hi_cc(a[1], b, O[1]);
#pragma unroll
  for (int j = 2; j < kWords - 2; j += 2) {
    O[j] = madc_lo_cc(a[j + 1], b, O[j]);
    O[j + 1] = madc_hi_cc(a[j + 1], b, O[j + 1]);
  }
  O[6] = madc_lo_cc(a[7], b, O[6]);
  O[7] = madc_hi(a[7], b, O[7]);
}

// Drop column 0 (E[0] == 0 after reduce_row) and add a*b one column down:
// O becomes the new even array (columns 0..7) and E the new odd one
// (columns 1..8).  E[1], which moves to column 0, is added to O[0] and its
// carry opens the new odd chain; E[k+2] is the addend of the new E[k].
__device__ __forceinline__ void shift_mul_row(uint32_t (&E)[kWords],
                                              uint32_t (&O)[kWords],
                                              const Fe& a, uint32_t b) {
  O[0] = add_cc(O[0], E[1]);
#pragma unroll
  for (int j = 0; j < kWords - 2; j += 2) {
    E[j] = madc_lo_cc(a.w[j + 1], b, E[j + 2]);
    E[j + 1] = madc_hi_cc(a.w[j + 1], b, E[j + 3]);
  }
  E[6] = madc_lo_cc(a.w[7], b, 0);
  E[7] = madc_hi(a.w[7], b, 0);
  O[0] = mad_lo_cc(a.w[0], b, O[0]);
  O[1] = madc_hi_cc(a.w[0], b, O[1]);
#pragma unroll
  for (int j = 2; j < kWords; j += 2) {
    O[j] = madc_lo_cc(a.w[j], b, O[j]);
    O[j + 1] = madc_hi_cc(a.w[j], b, O[j + 1]);
  }
  E[7] = addc(E[7], 0);
}

// CIOS Montgomery product a*b*2^-256 mod q for canonical a, b.
__device__ __forceinline__ Fe mont_mul_fe(const Fe& a, const Fe& b,
                                          const Modulus& m) {
  uint32_t e[kWords], o[kWords];
#pragma unroll
  for (int j = 0; j < kWords; j += 2) {
    // the first row adds to nothing; written as the other rows' pairs so
    // that it too becomes wide multiplies
    e[j] = (j == 0) ? mad_lo_cc(a.w[j], b.w[0], 0)
                    : madc_lo_cc(a.w[j], b.w[0], 0);
    e[j + 1] = madc_hi_cc(a.w[j], b.w[0], 0);
  }
#pragma unroll
  for (int j = 0; j < kWords; j += 2) {
    o[j] = (j == 0) ? mad_lo_cc(a.w[j + 1], b.w[0], 0)
                    : madc_lo_cc(a.w[j + 1], b.w[0], 0);
    o[j + 1] = madc_hi_cc(a.w[j + 1], b.w[0], 0);
  }
  reduce_row(e, o, m);
#pragma unroll
  for (int i = 1; i < kWords; i += 2) {
    shift_mul_row(e, o, a, b.w[i]);
    reduce_row(o, e, m);
    if (i + 1 < kWords) {
      shift_mul_row(o, e, a, b.w[i + 1]);
      reduce_row(e, o, m);
    }
  }
  // o is the even array now, e the odd one: drop column 0 and merge
  Fe r;
  r.w[0] = add_cc(e[0], o[1]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) r.w[k] = addc_cc(e[k], o[k + 1]);
  r.w[kWords - 1] = addc(e[kWords - 1], 0);
  return cond_sub_q(r, m);
}

// The two-lane Fq2 product's one CIOS pass (Fq2Lanes::mul):
// (a0*y0 + a1*y1)*2^-256 mod q, canonical, where y0 = hi ? pb : b,
// y1 = hi ? b : pb and pb is the partner lane's b, shuffled in one word a
// round (so no lane holds the partner's whole operand).  Each round adds the
// two rows a0*y0[i] and a1*y1[i] before its one reduction row: 2 x 64 + 72
// multiply-adds, where two products and an add take 2 x 136.  Every lane of
// the warp must call it together.  Range (q < 2^254, a0 < q, a1 <= q, b,
// pb < q): the sum is below 2q^2, so after round i the running value is
// below (2q*2^(32(i+1)) + q*2^(32(i+1))) / 2^(32(i+1)) = 3q and within a
// round below 3q + 3q*2^32 < 2^288, inside columns 0..8 as the one-product
// chain; the result (sum + M*q)/2^256 < 2q^2/2^256 + q < 1.5q, so one
// conditional subtraction makes it canonical.
__device__ __forceinline__ Fe mont_mul2_lanes(const Fe& a0, const Fe& a1,
                                              const Fe& b, bool hi,
                                              const Modulus& m) {
  uint32_t e[kWords], o[kWords];
  uint32_t pb = __shfl_xor_sync(kFullWarp, b.w[0], 1);
  const uint32_t y = hi ? pb : b.w[0];
#pragma unroll
  for (int j = 0; j < kWords; j += 2) {
    e[j] = (j == 0) ? mad_lo_cc(a0.w[j], y, 0) : madc_lo_cc(a0.w[j], y, 0);
    e[j + 1] = madc_hi_cc(a0.w[j], y, 0);
  }
#pragma unroll
  for (int j = 0; j < kWords; j += 2) {
    o[j] = (j == 0) ? mad_lo_cc(a0.w[j + 1], y, 0)
                    : madc_lo_cc(a0.w[j + 1], y, 0);
    o[j + 1] = madc_hi_cc(a0.w[j + 1], y, 0);
  }
  mul_row(e, o, a1.w, hi ? b.w[0] : pb);
  reduce_row(e, o, m);
#pragma unroll
  for (int i = 1; i < kWords; i += 2) {
    pb = __shfl_xor_sync(kFullWarp, b.w[i], 1);
    shift_mul_row(e, o, a0, hi ? pb : b.w[i]);
    mul_row(o, e, a1.w, hi ? b.w[i] : pb);
    reduce_row(o, e, m);
    if (i + 1 < kWords) {
      pb = __shfl_xor_sync(kFullWarp, b.w[i + 1], 1);
      shift_mul_row(o, e, a0, hi ? pb : b.w[i + 1]);
      mul_row(e, o, a1.w, hi ? b.w[i + 1] : pb);
      reduce_row(e, o, m);
    }
  }
  // o is the even array now, e the odd one: drop column 0 and merge
  Fe r;
  r.w[0] = add_cc(e[0], o[1]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) r.w[k] = addc_cc(e[k], o[k + 1]);
  r.w[kWords - 1] = addc(e[kWords - 1], 0);
  return cond_sub_q(r, m);
}

// Montgomery reduction t*2^-256 mod q of a 16-word t < q*2^256.  Round i
// clears word i; the carries out of its two chains (columns i+8 and i+9)
// are kept in `cw` and added once at the end, so no round ripples a carry
// up to the top.
__device__ __forceinline__ Fe mont_reduce_wide(uint32_t (&t)[2 * kWords],
                                               const Modulus& m) {
  uint32_t cw[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) cw[k] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t mi = t[i] * m.n0;
    t[i] = mad_lo_cc(m.q[0], mi, t[i]);
    t[i + 1] = madc_hi_cc(m.q[0], mi, t[i + 1]);
#pragma unroll
    for (int j = 2; j < kWords; j += 2) {
      t[i + j] = madc_lo_cc(m.q[j], mi, t[i + j]);
      t[i + j + 1] = madc_hi_cc(m.q[j], mi, t[i + j + 1]);
    }
    cw[i] = addc(cw[i], 0);
    t[i + 1] = mad_lo_cc(m.q[1], mi, t[i + 1]);
    t[i + 2] = madc_hi_cc(m.q[1], mi, t[i + 2]);
#pragma unroll
    for (int j = 3; j < kWords - 1; j += 2) {
      t[i + j] = madc_lo_cc(m.q[j], mi, t[i + j]);
      t[i + j + 1] = madc_hi_cc(m.q[j], mi, t[i + j + 1]);
    }
    t[i + 7] = madc_lo_cc(m.q[7], mi, t[i + 7]);
    if (i < kWords - 1) {
      t[i + 8] = madc_hi_cc(m.q[7], mi, t[i + 8]);
      cw[i + 1] = addc(cw[i + 1], 0);
    } else {
      t[15] = madc_hi(m.q[7], mi, t[15]);  // the total is below 2^512
    }
  }
  Fe r;
  r.w[0] = add_cc(t[kWords], cw[0]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) r.w[k] = addc_cc(t[kWords + k], cw[k]);
  r.w[kWords - 1] = addc(t[2 * kWords - 1], cw[kWords - 1]);
  return cond_sub_q(r, m);
}

// Montgomery square a*a*2^-256 mod q: the same bits as mont_mul_fe(a, a).
// The 28 cross products a_i*a_j (i < j) are summed once, in two arrays by
// the parity of their column (te[k]: column k, to[k]: column k+1) so that
// each row runs two independent chains, then merged, doubled, and the 8
// diagonal squares added in one chain over all 16 words.
__device__ __forceinline__ Fe mont_sqr_fe(const Fe& a, const Modulus& m) {
  uint32_t te[2 * kWords], to[2 * kWords];
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
    if (last != i + 7) to[last + 1] = addc(to[last + 1], 0);
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
    if (last != 0 && last != i + 8) te[last + 1] = addc(te[last + 1], 0);
  }
  uint32_t t[2 * kWords];
  t[0] = 0;  // no cross product reaches column 0
  t[1] = add_cc(te[1], to[0]);
#pragma unroll
  for (int k = 2; k < 2 * kWords - 1; ++k) t[k] = addc_cc(te[k], to[k - 1]);
  t[15] = addc(te[15], to[14]);
  t[1] = add_cc(t[1], t[1]);
#pragma unroll
  for (int k = 2; k < 2 * kWords - 1; ++k) t[k] = addc_cc(t[k], t[k]);
  t[15] = addc(t[15], t[15]);
  t[0] = mad_lo_cc(a.w[0], a.w[0], 0);
  t[1] = madc_hi_cc(a.w[0], a.w[0], t[1]);
#pragma unroll
  for (int i = 1; i < kWords - 1; ++i) {
    t[2 * i] = madc_lo_cc(a.w[i], a.w[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a.w[i], a.w[i], t[2 * i + 1]);
  }
  t[14] = madc_lo_cc(a.w[7], a.w[7], t[14]);
  t[15] = madc_hi(a.w[7], a.w[7], t[15]);
  return mont_reduce_wide(t, m);
}

// ---------------------------------------------------------------------------
// One interface over Fq and Fq2 elements, for the point add that G1 and G2
// share (kPlanes limb planes per element at the kernel boundary, kLanes
// lanes per element).

struct FqField {
  using El = Fe;
  static constexpr int kPlanes = 1;
  static constexpr int kLanes = 1;
  __device__ __forceinline__ static El load(const int32_t* const* p, int64_t n,
                                            int64_t i) {
    return load_fe(p[0], n, i);
  }
  __device__ __forceinline__ static void store(int32_t* const* p, int64_t n,
                                               int64_t i, const El& a) {
    store_fe(p[0], n, i, a);
  }
  __device__ __forceinline__ static El zero() { return zero_fe(); }
  __device__ __forceinline__ static bool is_zero(const El& a) {
    return is_zero_fe(a);
  }
  __device__ __forceinline__ static El select(bool pred, const El& a,
                                              const El& b) {
    return select_fe(pred, a, b);
  }
  __device__ __forceinline__ static El add(const El& a, const El& b,
                                           const Modulus& m) {
    return add_fe(a, b, m);
  }
  __device__ __forceinline__ static El sub(const El& a, const El& b,
                                           const Modulus& m) {
    return sub_fe(a, b, m);
  }
  __device__ __forceinline__ static El dbl(const El& a, const Modulus& m) {
    return dbl_fe(a, m);
  }
  __device__ __forceinline__ static El neg(const El& a, const Modulus& m) {
    return neg_fe(a, m);
  }
  __device__ __forceinline__ static El mul(const El& a, const El& b,
                                           const Modulus& m) {
    return mont_mul_fe(a, b, m);
  }
  __device__ __forceinline__ static El sqr(const El& a, const Modulus& m) {
    return mont_sqr_fe(a, m);
  }
};

// Fq2 = Fq[u]/(u^2 + 1), an element c0 + c1*u on two neighbouring lanes of a
// warp: the even lane holds c0, the odd lane c1 (`El` is the lane's own
// component).  Adds, subtractions and selects are the Fq ones on each lane;
// a product or a squaring takes the partner's component by shuffle, and the
// two lanes run the same instructions on operands they select, so a pair
// never splits its warp.  Every lane of the warp must call mul, sqr and
// is_zero together (full-warp shuffles), and a predicate handed to select
// must be the same on both lanes of a pair.  Needs q < 2^254 (BN254's q is
// below 2^253.6); the wrapper checks it.
__device__ __forceinline__ Fe shfl_partner(const Fe& a) {
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r.w[k] = __shfl_xor_sync(kFullWarp, a.w[k], 1);
  return r;
}

// a + b as 256-bit integers, no reduction (the caller keeps it below 2^256)
__device__ __forceinline__ Fe add_raw(const Fe& a, const Fe& b) {
  Fe s;
  s.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) s.w[k] = addc_cc(a.w[k], b.w[k]);
  s.w[kWords - 1] = addc(a.w[kWords - 1], b.w[kWords - 1]);
  return s;
}

// q - a for a <= q, no reduction: q itself for a = 0
__device__ __forceinline__ Fe q_minus(const Fe& a, const Modulus& m) {
  Fe d;
  d.w[0] = sub_cc(m.q[0], a.w[0]);
#pragma unroll
  for (int k = 1; k < kWords - 1; ++k) d.w[k] = subc_cc(m.q[k], a.w[k]);
  d.w[kWords - 1] = subc(m.q[kWords - 1], a.w[kWords - 1]);
  return d;
}

struct Fq2Lanes {
  using El = Fe;
  static constexpr int kPlanes = 2;
  static constexpr int kLanes = 2;
  __device__ __forceinline__ static bool odd() { return threadIdx.x & 1; }
  __device__ __forceinline__ static El load(const int32_t* const* p, int64_t n,
                                            int64_t i) {
    return load_fe(p[odd()], n, i);
  }
  __device__ __forceinline__ static void store(int32_t* const* p, int64_t n,
                                               int64_t i, const El& a) {
    store_fe(p[odd()], n, i, a);
  }
  __device__ __forceinline__ static El zero() { return zero_fe(); }
  // both components zero: the pair's two answers, and-ed
  __device__ __forceinline__ static bool is_zero(const El& a) {
    const unsigned z = is_zero_fe(a);
    return (z & __shfl_xor_sync(kFullWarp, z, 1)) != 0;
  }
  __device__ __forceinline__ static El select(bool pred, const El& a,
                                              const El& b) {
    return select_fe(pred, a, b);
  }
  __device__ __forceinline__ static El add(const El& a, const El& b,
                                           const Modulus& m) {
    return add_fe(a, b, m);
  }
  __device__ __forceinline__ static El sub(const El& a, const El& b,
                                           const Modulus& m) {
    return sub_fe(a, b, m);
  }
  __device__ __forceinline__ static El dbl(const El& a, const Modulus& m) {
    return dbl_fe(a, m);
  }
  __device__ __forceinline__ static El neg(const El& a, const Modulus& m) {
    return neg_fe(a, m);
  }
  // (a0 + a1 u)(b0 + b1 u) = (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u, each
  // component a sum of two products with one reduction (lazy reduction):
  //   even lane: a0*b0 + (q - a1)*b1      odd lane: a1*b0 + a0*b1
  // q - a1 stands for -a1 (it is q for a1 = 0, which mont_mul2_lanes'
  // range allows) and keeps the sum non-negative: below 2q^2.  The lane
  // takes its partner's a whole, and b one word a round.
  __device__ __forceinline__ static El mul(const El& a, const El& b,
                                           const Modulus& m) {
    const bool hi = odd();
    const Fe pa = shfl_partner(a);
    return mont_mul2_lanes(a, select_fe(hi, pa, q_minus(pa, m)), b, hi, m);
  }
  // (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u, one product a lane:
  //   even lane: (a0 + a1) * (a0 + q - a1)    odd lane: a0 * (a1 + a1)
  // unreduced factors below 2q: their product is below 4q^2 < q*2^256, so
  // mont_mul_fe's chain stays inside columns 0..8 (within a round below
  // 3q + 3q*2^32 < 2^288) and its result below 4q^2/2^256 + q < 2q, which
  // its one conditional subtraction makes canonical.
  __device__ __forceinline__ static El sqr(const El& a, const Modulus& m) {
    const bool hi = odd();
    const Fe pa = shfl_partner(a);
    const Fe x = add_raw(pa, select_fe(hi, zero_fe(), a));
    const Fe y = add_raw(a, select_fe(hi, a, q_minus(pa, m)));
    return mont_mul_fe(x, y, m);
  }
};

// ---------------------------------------------------------------------------
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
  const Fe z1z1 = mont_sqr_fe(Z1, m);
  const Fe u2 = mont_mul_fe(X2, z1z1, m);
  const Fe s2 = mont_mul_fe(Y2, mont_mul_fe(Z1, z1z1, m), m);
  const Fe h = sub_fe(u2, X1, m);
  const Fe hh = mont_sqr_fe(h, m);
  const Fe i_ = dbl_fe(dbl_fe(hh, m), m);
  const Fe j_ = mont_mul_fe(h, i_, m);
  const Fe r = dbl_fe(sub_fe(s2, Y1, m), m);
  const Fe v = mont_mul_fe(X1, i_, m);
  X3 = sub_fe(sub_fe(mont_sqr_fe(r, m), j_, m), dbl_fe(v, m), m);
  Y3 = sub_fe(mont_mul_fe(r, sub_fe(v, X3, m), m),
              dbl_fe(mont_mul_fe(Y1, j_, m), m), m);
  const Fe zh = add_fe(Z1, h, m);
  Z3 = sub_fe(sub_fe(mont_sqr_fe(zh, m), z1z1, m), hh, m);
  return is_zero_fe(h) || is_zero_fe(Z1);
}

}  // namespace ezt
