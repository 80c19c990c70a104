// The Poseidon2 rows of the verifier AIR's trace (models/recursion.py), on
// kernel E's lazy Goldilocks core: what one permutation slot of the trace
// holds, and the step that gives a Merkle path's next slot its input.
// Kernel E's verifier-rows entry (poseidon2_gl_rows.cu) runs both; the header
// also compiles on the host, as poseidon2_gl.cuh does, so the rows can be
// checked against the plain version without a GPU.
//
// A slot is 32 rows of 48 columns (Layout's `state`, `a2`, `a4`, `a6`):
//
//   row 0       the input state; no S-box powers (zeros)
//   row 1 + r   the state before round r (after the linear layer before it,
//               without round r's constants), and of t = state + rc_r, in
//               every lane, t^2, t^4 and t^6 (a partial round's lanes 1..11
//               too: their constants are zero, their powers still in the AIR)
//   row 31      the output state; zeros
//
// Every word written is canonical: each is one lazy product or linear-layer
// output, reduced once and then taken below p (`canon`), so the rows equal
// the plain version's (`_perm_rows_np`) bit for bit.  The round constants
// come from E's own `Consts`, which keeps them in the order the permutation
// adds them (riding on the linear layer before each round); `slot_rows`
// reads each round's from there.

#pragma once

#include "poseidon2_gl.cuh"

namespace ezt {
namespace poseidon2 {
namespace rows {

constexpr int kRows = 32;           // rows of a slot
constexpr int kCols = 4 * kWidth;   // state, t^2, t^4, t^6
constexpr int kPlanWords = kWidth + kDigest + 1;  // a plan entry: state, sibling, bit

__device__ __forceinline__ u64 word_sqr(u64 x) { return lz::canon(lz::reduce(lz::sqr(x))); }
__device__ __forceinline__ u64 word_mul(u64 x, u64 y) { return lz::canon(lz::reduce(lz::mul(x, y))); }

// s <- M_E·s, canonical (no constant rides on it here: the rows hold the
// state before the constants).
__device__ __forceinline__ void external_canon(u64 (&s)[kWidth]) {
  const u64 zero[kWidth] = {};
  external(s, zero);
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = lz::canon(s[i]);
}

// One round's row: the state, then its powers; s becomes the round's output.
template <class Sink>
__device__ __forceinline__ void full_round_rows(u64 (&s)[kWidth], const u64* rc, Sink& sink) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    sink.put(i, s[i]);
    const u64 t = lz::add(s[i], rc[i]);
    const u64 a2 = word_sqr(t), a4 = word_sqr(a2), a6 = word_mul(a4, a2);
    sink.put(kWidth + i, a2);
    sink.put(2 * kWidth + i, a4);
    sink.put(3 * kWidth + i, a6);
    s[i] = word_mul(a6, t);
  }
  external_canon(s);
}

// A partial round: lane 0 carries the constant and the S-box; M_I = 1 +
// diag(mu) as the total plus mu_i·s_i (mu canonical, the total below
// 12·2^64: `mul_add`'s bound).
template <class Sink>
__device__ __forceinline__ void partial_round_rows(u64 (&s)[kWidth], u64 rc0,
                                                   const u64 (&diag)[kWidth], Sink& sink) {
  u64 t0 = 0;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    sink.put(i, s[i]);
    const u64 t = i == 0 ? lz::add(s[0], rc0) : s[i];
    const u64 a2 = word_sqr(t), a4 = word_sqr(a2), a6 = word_mul(a4, a2);
    sink.put(kWidth + i, a2);
    sink.put(2 * kWidth + i, a4);
    sink.put(3 * kWidth + i, a6);
    if (i == 0) t0 = word_mul(a6, t);
  }
  s[0] = t0;
  const lz::Acc96 tot = lane_sum(s);
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = lz::canon(lz::reduce(lz::mul_add(s[i], diag[i], tot)));
}

template <class Sink>
__device__ __forceinline__ void edge_row(const u64 (&s)[kWidth], Sink& sink) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) sink.put(i, s[i]);
#pragma unroll
  for (int i = kWidth; i < kCols; ++i) sink.put(i, 0);
}

// The 32 rows of the slot whose input state is s (any words below 2^64):
// `sink.put(col, word)` for each of a row's 48 words, then `sink.row(r)`.
// s ends as the permutation's output, canonical.
template <class Sink>
__device__ __forceinline__ void slot_rows(u64 (&s)[kWidth], const Consts& c, Sink& sink) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = lz::canon(s[i]);
  edge_row(s, sink);
  sink.row(0);
  external_canon(s);
  int row = 1;
#pragma unroll 1
  for (int r = 0; r < kFull / 2; ++r) {  // rounds 0..3: rc_0, then full_next[0..2]
    full_round_rows(s, r == 0 ? c.first : c.full_next[r - 1], sink);
    sink.row(row++);
  }
#pragma unroll 1
  for (int j = 0; j < kPartial; ++j) {  // rounds 4..25: lane 0's constants
    partial_round_rows(s, j == 0 ? c.full_next[kFull / 2 - 1][0] : c.partial_next[j - 1], c.diag,
                       sink);
    sink.row(row++);
  }
#pragma unroll 1
  for (int r = 0; r < kFull / 2; ++r) {  // rounds 26..29: partial_last, then full_next[4..6]
    full_round_rows(s, r == 0 ? c.partial_last : c.full_next[kFull / 2 + r - 1], sink);
    sink.row(row++);
  }
  edge_row(s, sink);
  sink.row(kRows - 1);
}

// The input of a Merkle path's next slot: the previous slot's digest and the
// level's sibling, the sibling on the left where the bit is 1; lanes 8..11
// zero.  s holds the previous slot's output state (words) and becomes the
// input, canonical.
__device__ __forceinline__ void next_input(u64 (&s)[kWidth], const u64* sibling, u64 bit) {
#pragma unroll
  for (int j = 0; j < kDigest; ++j) {
    const u64 d = lz::canon(s[j]), sib = lz::canon(sibling[j]);
    s[j] = bit == 1 ? sib : d;
    s[kDigest + j] = bit == 1 ? d : sib;
    s[2 * kDigest + j] = 0;
  }
}

// A Merkle path's walk on the plan (entries of kPlanWords words, one a slot,
// in order): from the leaf slot's input state, each of the `depth` slots
// after it gets its input written into its entry (digests only: E's lazy
// permutation).
__device__ __forceinline__ void walk_path(u64* entry, int depth, const Consts& c) {
  u64 s[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) s[j] = entry[j];
#pragma unroll 1
  for (int k = 0; k < depth; ++k) {
    permute(s, c);
    entry += kPlanWords;
    next_input(s, entry + kWidth, entry[kWidth + kDigest]);
#pragma unroll
    for (int j = 0; j < kWidth; ++j) entry[j] = s[j];
  }
}

}  // namespace rows
}  // namespace poseidon2
}  // namespace ezt
