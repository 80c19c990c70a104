// Kernel E: Poseidon2 over Goldilocks (t = 12, x^7, 4 + 22 + 4 rounds,
// M_E = circ(2·M4, M4, M4), M_I = 1 + diag(mu), rate 8, digest 4, the length
// absorbed into lane 8), one thread per state.
//
// Replaces, on the card, what the JAX package computes in
// eigen_zeth_tpu/ops/poseidon.py:431 (`perm`), :494 (`hash_elements`) and
// :525 (`hash_two`) and, on its AIR path, in its native host hasher
// (eigen_zeth_tpu/native/poseidon2.py:76-118).  Three entry points:
//
//   ezt_poseidon2_perm       (N, 12) states -> (N, 12)
//   ezt_poseidon2_hash_rows  (N, k) rows -> (N, 4) digests, the whole sponge
//                            of a row in one thread, any k >= 0
//   ezt_poseidon2_hash_two   (N, 4) x (N, 4) -> (N, 4), a Merkle level
//
// What bounds it on the H100.  A permutation is 736 field products (8 full
// rounds x 12 lanes x 4 for x^7, 22 partial rounds x (4 + 12 for the
// diagonal)), each four 32 x 32 wide multiply-adds and a fold of compares and
// adds, against 32 to 96 bytes moved: by the card's rates the integer pipe
// takes hundreds of times longer than the memory, so the kernel is bound by
// operations at every shape.  The design follows from that: the twelve lanes
// stay in registers through all 30 rounds (the plain PyTorch version writes
// every intermediate of every round to device memory, about 9,000 small
// launches a permutation), the sponge of a whole row runs in one thread so
// that nothing but the row and its digest touches memory, and the round
// constants sit in the kernel's parameter bank, read uniformly by a warp.
// The round loops are not unrolled (one copy of a full and of a partial round
// keeps the code in the instruction cache); the lane loops are.
//
// `hash_rows` takes the row and column strides of its input, so the caller
// hands it a column-major matrix (the AIR prover's (columns, coset) LDE) as
// it lies: thread i then reads element j of row i at in[j·col_stride + i],
// neighbouring threads neighbouring words.  Inputs must be canonical (< p);
// outputs are, and equal the plain version's bit for bit.

#include <cuda_runtime.h>

#include <cstring>

#include "goldilocks.cuh"

namespace {

using ezt::gl::u64;
namespace gl = ezt::gl;

constexpr int kThreads = 256;
constexpr int kWidth = 12;
constexpr int kRate = 8;
constexpr int kDigest = 4;
constexpr int kHalfFull = 4;
constexpr int kPartial = 22;

// The instance's constants as the host lays them out: the additive constants
// of the 8 full rounds (first half, then second half), lane 0's constant of
// each partial round, the internal diagonal.  130 words.
struct Consts {
  u64 full[2 * kHalfFull][kWidth];
  u64 partial[kPartial];
  u64 diag[kWidth];
};

// M4 by the Poseidon2 addition chain.
__device__ __forceinline__ void m4(u64& x0, u64& x1, u64& x2, u64& x3) {
  const u64 t0 = gl::add(x0, x1);
  const u64 t1 = gl::add(x2, x3);
  const u64 t2 = gl::add(gl::dbl(x1), t1);
  const u64 t3 = gl::add(gl::dbl(x3), t0);
  const u64 t4 = gl::add(gl::dbl(gl::dbl(t1)), t3);
  const u64 t5 = gl::add(gl::dbl(gl::dbl(t0)), t2);
  x0 = gl::add(t3, t5);
  x1 = t5;
  x2 = gl::add(t2, t4);
  x3 = t4;
}

// s <- circ(2·M4, M4, M4)·s
__device__ __forceinline__ void external(u64 (&s)[kWidth]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) m4(s[4 * b], s[4 * b + 1], s[4 * b + 2], s[4 * b + 3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const u64 tot = gl::add(gl::add(s[i], s[4 + i]), s[8 + i]);
    s[i] = gl::add(s[i], tot);
    s[4 + i] = gl::add(s[4 + i], tot);
    s[8 + i] = gl::add(s[8 + i], tot);
  }
}

__device__ __forceinline__ u64 sbox(u64 x) {
  const u64 x2 = gl::sqr(x);
  const u64 x4 = gl::sqr(x2);
  return gl::mul(gl::mul(x4, x2), x);
}

__device__ __forceinline__ void full_round(u64 (&s)[kWidth], const u64* rc) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = sbox(gl::add(s[i], rc[i]));
  external(s);
}

__device__ __forceinline__ void permute(u64 (&s)[kWidth], const Consts& c) {
  external(s);
#pragma unroll 1
  for (int r = 0; r < kHalfFull; ++r) full_round(s, c.full[r]);
#pragma unroll 1
  for (int r = 0; r < kPartial; ++r) {
    s[0] = sbox(gl::add(s[0], c.partial[r]));
    u64 lo = gl::add(gl::add(s[0], s[1]), gl::add(s[2], s[3]));
    u64 mid = gl::add(gl::add(s[4], s[5]), gl::add(s[6], s[7]));
    u64 hi = gl::add(gl::add(s[8], s[9]), gl::add(s[10], s[11]));
    const u64 tot = gl::add(gl::add(lo, mid), hi);
#pragma unroll
    for (int i = 0; i < kWidth; ++i) s[i] = gl::add(tot, gl::mul(s[i], c.diag[i]));
  }
#pragma unroll 1
  for (int r = kHalfFull; r < 2 * kHalfFull; ++r) full_round(s, c.full[r]);
}

__global__ void __launch_bounds__(kThreads)
    perm_kernel(const u64* __restrict__ in, u64* __restrict__ out, int64_t n,
                const __grid_constant__ Consts c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 s[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) s[j] = in[i * kWidth + j];
  permute(s, c);
#pragma unroll
  for (int j = 0; j < kWidth; ++j) out[i * kWidth + j] = s[j];
}

// The sponge of row i: lane 8 starts at k, every block of 8 elements is added
// into lanes 0..7 and permuted (an empty row still takes one permutation),
// the digest is lanes 0..3.
__global__ void __launch_bounds__(kThreads)
    hash_rows_kernel(const u64* __restrict__ in, u64* __restrict__ out, int64_t n,
                     int64_t k, int64_t row_stride, int64_t col_stride,
                     const __grid_constant__ Consts c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 s[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) s[j] = 0;
  s[kRate] = static_cast<u64>(k);
  const u64* row = in + i * row_stride;
  const int64_t blocks = k > 0 ? (k + kRate - 1) / kRate : 1;
#pragma unroll 1
  for (int64_t b = 0; b < blocks; ++b) {
#pragma unroll
    for (int j = 0; j < kRate; ++j) {
      const int64_t e = b * kRate + j;
      if (e < k) s[j] = gl::add(s[j], row[e * col_stride]);
    }
    permute(s, c);
  }
#pragma unroll
  for (int j = 0; j < kDigest; ++j) out[i * kDigest + j] = s[j];
}

__global__ void __launch_bounds__(kThreads)
    hash_two_kernel(const u64* __restrict__ left, int64_t left_stride,
                    const u64* __restrict__ right, int64_t right_stride,
                    u64* __restrict__ out, int64_t n,
                    const __grid_constant__ Consts c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 s[kWidth];
#pragma unroll
  for (int j = 0; j < kDigest; ++j) {
    s[j] = left[i * left_stride + j];
    s[kDigest + j] = right[i * right_stride + j];
    s[2 * kDigest + j] = 0;
  }
  permute(s, c);
#pragma unroll
  for (int j = 0; j < kDigest; ++j) out[i * kDigest + j] = s[j];
}

inline Consts load_consts(const void* words) {
  Consts c;
  std::memcpy(&c, words, sizeof(c));
  return c;
}

inline unsigned grid(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// All pointers but `consts` are device pointers to canonical 64-bit words;
// `consts` is a host pointer to the 130 words of `Consts`; strides count
// words.  Each function returns the cudaError_t of its launch (0 on success).

// in, out: (n, 12) contiguous states.
extern "C" int ezt_poseidon2_perm(const void* in, void* out, long long n,
                                  const void* consts, void* stream) {
  perm_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), static_cast<u64*>(out), n, load_consts(consts));
  return static_cast<int>(cudaGetLastError());
}

// in: n rows of k elements, element j of row i at in[i·row_stride +
// j·col_stride]; out: (n, 4) contiguous digests.
extern "C" int ezt_poseidon2_hash_rows(const void* in, void* out, long long n,
                                       long long k, long long row_stride,
                                       long long col_stride, const void* consts,
                                       void* stream) {
  hash_rows_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), static_cast<u64*>(out), n, k, row_stride,
      col_stride, load_consts(consts));
  return static_cast<int>(cudaGetLastError());
}

// left, right: n digests of 4 contiguous words, digest i at i·stride; out:
// (n, 4) contiguous.
extern "C" int ezt_poseidon2_hash_two(const void* left, long long left_stride,
                                      const void* right, long long right_stride,
                                      void* out, long long n, const void* consts,
                                      void* stream) {
  hash_two_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(left), left_stride, static_cast<const u64*>(right),
      right_stride, static_cast<u64*>(out), n, load_consts(consts));
  return static_cast<int>(cudaGetLastError());
}
