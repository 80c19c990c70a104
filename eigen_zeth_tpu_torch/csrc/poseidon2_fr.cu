// Kernel F: Poseidon2 over BN254 Fr (t = 12, x^5, 4 + 68 + 4 rounds, M_E =
// circ(2·M4, M4, M4), M_I = 1 + diag(mu), rate 11, capacity 1, a digest of
// one Fr element), one thread per state, on kernel A's Montgomery core
// (bn254_field.cuh: eight 32-bit words an element, R = 2^256).
//
// Replaces, on the card, what the JAX package computes in
// eigen_zeth_tpu/ops/poseidon_fr.py:271-309 (`_perm_device_run`,
// `perm_device`: every product a `MontCtx.mont_mul`, which is the Pallas
// kernel A on the TPU) and the device Merkle commit built on it,
// eigen_zeth_tpu/models/merkle_fr.py:95-131 (`_leaf_digests_device`,
// `_compress_level_device`), whose place its host C++ engine took
// (merkle_fr.py:140-160).  Three entry points:
//
//   ezt_poseidon_fr_perm           (N, 12) states -> (N, 12)
//   ezt_poseidon_fr_hash_rows      (N, k) Goldilocks rows -> (N,) digests:
//                                  packed 3 to an Fr element as the rows
//                                  lie (any strides), the leaf sponge of a
//                                  row in one thread
//   ezt_poseidon_fr_merkle_levels  N leaf digests -> every level above
//                                  (a whole tree) in one launch
//
// An Fr value at the boundary is four 64-bit words, little end first,
// canonical, in regular form; the kernel enters Montgomery form with one
// product by R^2 and leaves it with one product by 1.
//
// What bounds it on the H100: the integer multiply pipe.  A permutation is
// 980 Montgomery products and 328 squarings (8 full rounds x 12 S-boxes x
// (2 squarings + 1 product); 68 partial rounds x (2 squarings + 1 product
// + 12 diagonal products)), 168,704 multiply-adds, against at most a few
// hundred bytes moved.  This first design is the simple one: the twelve
// lanes in registers through all 76 rounds, every intermediate canonical,
// the round constants and the diagonal in constant memory (one uniform
// address a warp), no shared memory.  The tree entry is kernel E's: every
// level at the width of a block, the block that finishes second of a
// sibling pair (an atomic ticket after a fence) going on to the level
// above, so nothing waits and a tree is one launch.
//
// Outputs equal the plain version's (ops/poseidon_fr.py) bit for bit.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

#include "bn254_field.cuh"

namespace {

using ezt::Fe;
using ezt::Modulus;

constexpr int kWidth = 12;
constexpr int kRate = 11;
constexpr int kFull = 8;
constexpr int kHalf = kFull / 2;
constexpr int kPartial = 68;
constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;

// The instance's constants in Montgomery form, in this order (the host
// array of `kernels.poseidon_fr_const_words()`).
struct FrConsts {
  Fe rc_full[kFull][kWidth];
  Fe rc_part[kPartial];
  Fe mu[kWidth];
  Fe r2;  // R^2 mod r: a regular value times it is its Montgomery form
};

__constant__ FrConsts c_fr;

__device__ __forceinline__ Fe add(const Fe& a, const Fe& b, const Modulus& m) {
  return ezt::add_fe(a, b, m);
}

__device__ __forceinline__ Fe sbox(const Fe& x, const Modulus& m) {
  const Fe x2 = ezt::mont_sqr_fe(x, m);
  const Fe x4 = ezt::mont_sqr_fe(x2, m);
  return ezt::mont_mul_fe(x4, x, m);
}

// M_E: the three M4 blocks in place, then each lane plus its column's sum.
__device__ __forceinline__ void external(Fe (&s)[kWidth], const Modulus& m) {
#pragma unroll
  for (int k = 0; k < kWidth; k += 4) {
    const Fe t0 = add(s[k], s[k + 1], m);
    const Fe t1 = add(s[k + 2], s[k + 3], m);
    const Fe t2 = add(ezt::dbl_fe(s[k + 1], m), t1, m);
    const Fe t3 = add(ezt::dbl_fe(s[k + 3], m), t0, m);
    const Fe t4 = add(ezt::dbl_fe(ezt::dbl_fe(t1, m), m), t3, m);
    const Fe t5 = add(ezt::dbl_fe(ezt::dbl_fe(t0, m), m), t2, m);
    s[k] = add(t3, t5, m);
    s[k + 1] = t5;
    s[k + 2] = add(t2, t4, m);
    s[k + 3] = t4;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Fe sum = add(add(s[j], s[4 + j], m), s[8 + j], m);
    s[j] = add(s[j], sum, m);
    s[4 + j] = add(s[4 + j], sum, m);
    s[8 + j] = add(s[8 + j], sum, m);
  }
}

__device__ __forceinline__ void full_round(Fe (&s)[kWidth], int r, const Modulus& m) {
#pragma unroll
  for (int i = 0; i < kWidth; ++i) s[i] = sbox(add(s[i], c_fr.rc_full[r][i], m), m);
  external(s, m);
}

// The permutation of a Montgomery-form state, the JAX package's
// `_perm_device_run` round for round.
__device__ void permute(Fe (&s)[kWidth], const Modulus& m) {
  external(s, m);
#pragma unroll 1
  for (int r = 0; r < kHalf; ++r) full_round(s, r, m);
#pragma unroll 1
  for (int r = 0; r < kPartial; ++r) {
    s[0] = sbox(add(s[0], c_fr.rc_part[r], m), m);
    Fe tot = s[0];
#pragma unroll
    for (int i = 1; i < kWidth; ++i) tot = add(tot, s[i], m);
#pragma unroll
    for (int i = 0; i < kWidth; ++i) s[i] = add(tot, ezt::mont_mul_fe(c_fr.mu[i], s[i], m), m);
  }
#pragma unroll 1
  for (int r = kHalf; r < kFull; ++r) full_round(s, r, m);
}

// Four 64-bit words <-> eight 32-bit ones.
__device__ __forceinline__ Fe load_words(const uint64_t* p) {
  Fe r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t v = p[j];
    r.w[2 * j] = static_cast<uint32_t>(v);
    r.w[2 * j + 1] = static_cast<uint32_t>(v >> 32);
  }
  return r;
}

__device__ __forceinline__ void store_words(uint64_t* p, const Fe& a) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p[j] = static_cast<uint64_t>(a.w[2 * j]) | (static_cast<uint64_t>(a.w[2 * j + 1]) << 32);
}

__device__ __forceinline__ Fe to_mont(const Fe& x, const Modulus& m) {
  return ezt::mont_mul_fe(x, c_fr.r2, m);
}

__device__ __forceinline__ Fe from_mont(const Fe& x, const Modulus& m) {
  Fe one = ezt::zero_fe();
  one.w[0] = 1;
  return ezt::mont_mul_fe(x, one, m);
}

__global__ void __launch_bounds__(kThreads)
    perm_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n,
                Modulus m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe s[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) s[j] = to_mont(load_words(in + (i * kWidth + j) * 4), m);
  permute(s, m);
#pragma unroll
  for (int j = 0; j < kWidth; ++j) store_words(out + (i * kWidth + j) * 4, from_mont(s[j], m));
}

// The leaf sponge of row i: packed element e holds the row's Goldilocks
// values 3e, 3e+1, 3e+2 (those below k) in its words 0, 1, 2; lane 11 starts
// at `cap` (the leaf tag plus the packed length), every block of 11 packed
// elements is added into lanes 0..10 and permuted, the digest is lane 0.
__global__ void __launch_bounds__(kThreads)
    hash_rows_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n,
                     int64_t k, int64_t row_stride, int64_t col_stride, Fe cap, Modulus m) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe s[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth - 1; ++j) s[j] = ezt::zero_fe();
  s[kWidth - 1] = cap;
  const uint64_t* row = in + i * row_stride;
  const int64_t packed = (k + 2) / 3;
#pragma unroll 1
  for (int64_t b = 0; b < packed; b += kRate) {
#pragma unroll
    for (int j = 0; j < kRate; ++j) {
      const int64_t e = b + j;
      if (e < packed) {
        Fe x = ezt::zero_fe();
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const int64_t col = 3 * e + t;
          const uint64_t v = col < k ? row[col * col_stride] : 0;
          x.w[2 * t] = static_cast<uint32_t>(v);
          x.w[2 * t + 1] = static_cast<uint32_t>(v >> 32);
        }
        s[j] = add(s[j], to_mont(x, m), m);
      }
    }
    permute(s, m);
  }
  store_words(out + i * 4, from_mont(s[0], m));
}

// The 2-to-1 compression: lanes 0, 1 the children, lane 11 the node tag;
// `via_l2` reads the children past this SM's L1 (another block wrote them).
__device__ __forceinline__ Fe compress(const uint64_t* left, const uint64_t* right, bool via_l2,
                                       const Fe& cap, const Modulus& m) {
  uint64_t w[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = via_l2 ? __ldcg(left + j) : left[j];
    w[4 + j] = via_l2 ? __ldcg(right + j) : right[j];
  }
  Fe s[kWidth];
  s[0] = to_mont(load_words(w), m);
  s[1] = to_mont(load_words(w + 4), m);
#pragma unroll
  for (int j = 2; j < kWidth - 1; ++j) s[j] = ezt::zero_fe();
  s[kWidth - 1] = cap;
  permute(s, m);
  return from_mont(s[0], m);
}

constexpr int kMaxLevels = 63;

struct LevelOuts {
  uint64_t* level[kMaxLevels];  // level j + 1 above the leaves: (n >> (j + 1), 4)
};

// Every level above the n leaf digests `in` (contiguous (n, 4) words), at
// the width of a block: block x first hashes nodes x·128 .. x·128 + 127 of
// level 1; after each level the block that finishes second of a pair of
// sibling groups (an atomic ticket after a fence that publishes the
// group's digests) goes on to the nodes above the pair, the other exits.
// `tickets`: zeroed, one counter per pair of groups and level.
__global__ void __launch_bounds__(kThreads)
    merkle_levels_kernel(const uint64_t* in, int64_t n, LevelOuts outs,
                         unsigned* __restrict__ tickets, Fe cap, Modulus m) {
  __shared__ unsigned last;
  const int t = threadIdx.x;
  int64_t group = blockIdx.x;
  int64_t width = n >> 1;
  unsigned* ticket = tickets;
  const uint64_t* below = in;
  for (int lv = 0; width > 0; ++lv) {
    const int64_t node = group * kThreads + t;
    if (node < width) {
      const uint64_t* pair = below + 2 * node * 4;
      store_words(outs.level[lv] + node * 4, compress(pair, pair + 4, lv != 0, cap, m));
    }
    if (width > kThreads) {  // two or more groups: meet the sibling
      __threadfence();
      __syncthreads();
      if (t == 0) last = atomicAdd(ticket + (group >> 1), 1u);
      __syncthreads();
      if (last == 0) return;  // the sibling goes on
      __threadfence();
      ticket += width / (2 * kThreads);
      group >>= 1;
    } else {
      __syncthreads();  // this block wrote the whole level
    }
    below = outs.level[lv];
    width >>= 1;
  }
}

// Upload the constants to the current device once.
int upload_consts(const void* words) {
  static std::mutex mu;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    err = cudaMemcpyToSymbol(c_fr, words, sizeof(FrConsts));
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

inline Fe fe_of(const void* words) {
  Fe r;
  std::memcpy(r.w, words, sizeof(r.w));
  return r;
}

inline unsigned grid(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Pointers `in`, `out`, `tickets` and the level pointers are device pointers
// to 64-bit words; `q_words`, `cap_words` (an Fr value in Montgomery form)
// and `consts` (the 177 Montgomery values of FrConsts) are host pointers to
// little-endian 32-bit words.  Each function returns the cudaError_t of its
// launch (0 on success).

// in, out: (n, 12, 4) contiguous words.
extern "C" int ezt_poseidon_fr_perm(const void* in, void* out, long long n,
                                    const void* q_words, unsigned n0, const void* consts,
                                    void* stream) {
  if (int rc = upload_consts(consts)) return rc;
  perm_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n,
      ezt::make_modulus(q_words, n0));
  return static_cast<int>(cudaGetLastError());
}

// in: n rows of k canonical Goldilocks words, word j of row i at
// in[i·row_stride + j·col_stride]; out: (n, 4) contiguous digests.
extern "C" int ezt_poseidon_fr_hash_rows(const void* in, void* out, long long n, long long k,
                                         long long row_stride, long long col_stride,
                                         const void* cap_words, const void* q_words,
                                         unsigned n0, const void* consts, void* stream) {
  if (int rc = upload_consts(consts)) return rc;
  hash_rows_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n, k, row_stride,
      col_stride, fe_of(cap_words), ezt::make_modulus(q_words, n0));
  return static_cast<int>(cudaGetLastError());
}

// in: (n, 4) contiguous leaf digests, n a power of two, n >= 2; outs: a host
// array of log2(n) device pointers, level j (from 1) a contiguous
// (n >> j, 4) tensor; tickets: max(1, n / 256) zeroed device words.
extern "C" int ezt_poseidon_fr_merkle_levels(const void* in, long long n,
                                             const void* const* outs, void* tickets,
                                             const void* cap_words, const void* q_words,
                                             unsigned n0, const void* consts, void* stream) {
  if (n < 2 || (n & (n - 1))) return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = upload_consts(consts)) return rc;
  LevelOuts o{};
  int levels = 0;
  while ((n >> levels) > 1) ++levels;
  for (int j = 0; j < levels; ++j) o.level[j] = static_cast<uint64_t*>(const_cast<void*>(outs[j]));
  const long long groups = (n / 2 + kThreads - 1) / kThreads;
  merkle_levels_kernel<<<static_cast<unsigned>(groups), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), n, o, static_cast<unsigned*>(tickets),
      fe_of(cap_words), ezt::make_modulus(q_words, n0));
  return static_cast<int>(cudaGetLastError());
}
