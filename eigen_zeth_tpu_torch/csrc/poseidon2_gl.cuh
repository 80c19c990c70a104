// The Poseidon2 permutation over Goldilocks on the lazy field core (t = 12,
// x^7, 4 + 22 + 4 rounds, M_E = circ(2·M4, M4, M4), M_I = 1 + diag(mu)),
// one state in one thread's registers.  Kernel E (poseidon2_gl.cu) runs it;
// the header also compiles on the host (goldilocks.cuh emulates the carry
// flag there) so the schedule can be checked without a GPU.
//
// The schedule, and the bound each step keeps (a word is below 2^64):
//
//   * the external layer forms each of its 12 outputs as one 96-bit sum: M4
//     by the Poseidon2 addition chain on accumulators (an M4 output is at
//     most 16 x its largest input, below 2^68), the column sums of the three
//     blocks (below 48·2^64), each output z + column sum + the next round's
//     constant (below 65·2^64 < 2^71), then one reduction per output;
//   * the round constants ride on those sums, so a full round's S-box input
//     is a word as it comes out of the reduction; a partial round carries
//     lane 0's next constant the same way;
//   * x^7 as x^2, x^4 = (x^2)^2, x^3 = x^2·x, x^7 = x^4·x^3: four products of
//     words, each reduced once, three deep;
//   * a partial round sums the 12 lanes once (below 12·2^64) and forms lane i
//     as tot + mu_i·s_i (+ a canonical constant) in one 128-bit accumulator:
//     mu_i is canonical, so the sum stays below 2^128 (goldilocks.cuh,
//     `mul_add`), and one reduction makes the word;
//   * nothing between two permutations is canonical: a sponge adds its next
//     block to the words lazily, and only what leaves the kernel goes
//     through `canon`.

#pragma once

#include "goldilocks.cuh"

namespace ezt {
namespace poseidon2 {

using gl::u64;
namespace lz = gl::lazy;

constexpr int kWidth = 12;
constexpr int kRate = 8;
constexpr int kDigest = 4;
constexpr int kFull = 8;
constexpr int kPartial = 22;

// The instance's constants in the order the schedule adds them (the host
// lays them out, ops/kernels.py `_poseidon2_consts`): each round's
// constants ride on the linear layer before it.  153 words.
struct Consts {
  u64 first[kWidth];              // round 0's, after the first linear layer
  u64 full_next[kFull][kWidth];   // after full round r's linear layer: the
                                  // next round's (lane 0 only before the
                                  // partial rounds, none after the last)
  u64 partial_next[kPartial - 1]; // after partial round j: lane 0's of j + 1
  u64 partial_last[kWidth];       // after the last partial round: the next
                                  // full round's
  u64 diag[kWidth];               // mu_i
};

// M4 by the addition chain, on 96-bit accumulators: outputs below 16·2^64.
__device__ __forceinline__ void m4(u64 x0, u64 x1, u64 x2, u64 x3, lz::Acc96 (&y)[4]) {
  const lz::Acc96 t0 = lz::sum(x0, x1);                  // < 2·2^64
  const lz::Acc96 t1 = lz::sum(x2, x3);
  const lz::Acc96 t2 = lz::acc(lz::sum(x1, x1), t1);     // < 4·2^64
  const lz::Acc96 t3 = lz::acc(lz::sum(x3, x3), t0);
  const lz::Acc96 t4 = lz::acc(lz::shl<2>(t1), t3);      // < 12·2^64
  const lz::Acc96 t5 = lz::acc(lz::shl<2>(t0), t2);
  y[0] = lz::acc(t3, t5);                                // < 16·2^64
  y[1] = t5;
  y[2] = lz::acc(t2, t4);
  y[3] = t4;
}

// s <- circ(2·M4, M4, M4)·s + add, each output reduced once; add: canonical.
__device__ __forceinline__ void external(u64 (&s)[kWidth], const u64* add) {
  lz::Acc96 z[3][4];
#pragma unroll
  for (int b = 0; b < 3; ++b) m4(s[4 * b], s[4 * b + 1], s[4 * b + 2], s[4 * b + 3], z[b]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const lz::Acc96 tot = lz::acc(lz::acc(z[0][i], z[1][i]), z[2][i]);  // < 48·2^64
#pragma unroll
    for (int b = 0; b < 3; ++b)
      s[4 * b + i] = lz::reduce(lz::acc(lz::acc(z[b][i], tot), add[4 * b + i]));
  }
}

__device__ __forceinline__ u64 sbox(u64 x) {
  const u64 x2 = lz::reduce(lz::sqr(x));
  const u64 x4 = lz::reduce(lz::sqr(x2));
  const u64 x3 = lz::reduce(lz::mul(x2, x));
  return lz::reduce(lz::mul(x4, x3));
}

// The 12 lanes summed: below 12·2^64.
__device__ __forceinline__ lz::Acc96 lane_sum(const u64 (&s)[kWidth]) {
  lz::Acc96 tot = lz::sum(s[1], s[2]);
#pragma unroll
  for (int i = 3; i < kWidth; ++i) tot = lz::acc(tot, s[i]);
  return lz::acc(tot, s[0]);
}

// One partial round on an S-box input in lane 0; lane 0 then carries the
// next round's constant `next0`.
__device__ __forceinline__ void partial_round(u64 (&s)[kWidth], u64 next0,
                                              const u64 (&diag)[kWidth]) {
  s[0] = sbox(s[0]);
  const lz::Acc96 tot = lane_sum(s);
  s[0] = lz::reduce(lz::mul_add(s[0], diag[0], lz::acc(tot, next0)));
#pragma unroll
  for (int i = 1; i < kWidth; ++i) s[i] = lz::reduce(lz::mul_add(s[i], diag[i], tot));
}

// The last partial round: every lane carries the next full round's constant.
__device__ __forceinline__ void partial_round_last(u64 (&s)[kWidth], const u64* next,
                                                   const u64 (&diag)[kWidth]) {
  s[0] = sbox(s[0]);
  const lz::Acc96 tot = lane_sum(s);
#pragma unroll
  for (int i = 0; i < kWidth; ++i)
    s[i] = lz::reduce(lz::mul_add(s[i], diag[i], lz::acc(tot, next[i])));
}

// The permutation of words (any values below 2^64); the result is words.
// The round loops are not unrolled: one copy of a full round and of a
// partial round keeps the code in the instruction cache; the lane loops are.
__device__ __forceinline__ void permute(u64 (&s)[kWidth], const Consts& c) {
  external(s, c.first);
#pragma unroll 1
  for (int r = 0; r < kFull; ++r) {
#pragma unroll
    for (int i = 0; i < kWidth; ++i) s[i] = sbox(s[i]);
    external(s, c.full_next[r]);
    if (r == kFull / 2 - 1) {
#pragma unroll 1
      for (int j = 0; j < kPartial - 1; ++j) partial_round(s, c.partial_next[j], c.diag);
      partial_round_last(s, c.partial_last, c.diag);
    }
  }
}

}  // namespace poseidon2
}  // namespace ezt
