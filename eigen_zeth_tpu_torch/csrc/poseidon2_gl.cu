// Kernel E: Poseidon2 over Goldilocks (t = 12, x^7, 4 + 22 + 4 rounds,
// M_E = circ(2·M4, M4, M4), M_I = 1 + diag(mu), rate 8, digest 4, the length
// absorbed into lane 8), one thread per state.
//
// Replaces, on the card, what the JAX package computes in
// eigen_zeth_tpu/ops/poseidon.py:431 (`perm`), :494 (`hash_elements`) and
// :525 (`hash_two`), in eigen_zeth_tpu/models/merkle.py:62-73 and :184-220
// (`commit_digests`, `_tree_prog`: a Merkle tree, one or several levels an
// XLA program) and, on its AIR path, in its native host hasher
// (eigen_zeth_tpu/native/poseidon2.py:76-118).  Four entry points:
//
//   ezt_poseidon2_perm          (N, 12) states -> (N, 12)
//   ezt_poseidon2_hash_rows     (N, k) rows -> (N, 4) digests, the whole
//                               sponge of a row in one thread, any k >= 0
//   ezt_poseidon2_hash_two      (N, 4) x (N, 4) -> (N, 4), a Merkle level
//   ezt_poseidon2_merkle_levels K trees' level of n digests -> every level
//                               above it (a whole tree) in one launch
//
// The Merkle commits of the port run the tree entry; `hash_two` stays as the
// card's form of `poseidon.hash_two` (the JAX package's `hash_two`, one level
// of pairs at any strides), the entry that earlier kernels of E also have.
//
// What bounds it on the H100: instruction issue.  A permutation is 736
// products of 64-bit words (8 full rounds x 12 lanes x 4 for x^7, 22
// partial rounds x (4 + 12 for the diagonal)) against 32 to 96 bytes moved,
// so the integer pipes, not the memory, set its time at every shape.  The
// permutation lives in poseidon2_gl.cuh on the lazy field core of
// goldilocks.cuh: the twelve lanes stay in registers through all 30 rounds
// as 64-bit words that need not be canonical, sums gather in 96- and 128-bit
// accumulators on carry chains, each product and each linear-layer output
// is reduced once, the round constants ride on those sums, and only what
// leaves the kernel is made canonical (keeping every intermediate canonical
// costs about two thirds of what a permutation issues).  The constants sit
// in the kernel's parameter bank (`__grid_constant__`), read uniformly by a
// warp.
//
// `hash_rows` takes the row and column strides of its input, so the caller
// hands it a column-major matrix (the AIR prover's (columns, coset) LDE) as
// it lies: thread i then reads element j of row i at in[j·col_stride + i],
// neighbouring threads neighbouring words.
//
// `merkle_levels` takes the place of one `hash_two` launch per level:
// every level runs at the width of a block (`merkle_levels_kernel`), its
// first level read in place with the strides `hash_two` takes, every level
// written to its own contiguous (K, n / 2^j, 4) tensor, a whole tree in one
// launch.  Not a subtree per block in shared memory: its top levels would
// run on one partly filled warp while the rest of the block waits at the
// barrier holding its registers (measured slower than level by level).
//
// Inputs must be canonical (< p); outputs are, and equal the plain
// version's bit for bit.

#include <cuda_runtime.h>

#include <cstring>

#include "poseidon2_gl.cuh"

namespace {

using ezt::gl::u64;
namespace lz = ezt::gl::lazy;
namespace p2 = ezt::poseidon2;
using p2::Consts;
using p2::kDigest;
using p2::kRate;
using p2::kWidth;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    perm_kernel(const u64* __restrict__ in, u64* __restrict__ out, int64_t n,
                const __grid_constant__ Consts c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 s[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) s[j] = in[i * kWidth + j];
  p2::permute(s, c);
#pragma unroll
  for (int j = 0; j < kWidth; ++j) out[i * kWidth + j] = lz::canon(s[j]);
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
      if (e < k) s[j] = lz::add(s[j], row[e * col_stride]);
    }
    p2::permute(s, c);
  }
#pragma unroll
  for (int j = 0; j < kDigest; ++j) out[i * kDigest + j] = lz::canon(s[j]);
}

// The 2-to-1 compression of two digests into `d`; `via_l2` reads them
// through L2, past this SM's L1, where another block of the launch wrote them.
__device__ __forceinline__ void compress(const u64* left, const u64* right, bool via_l2,
                                         u64 (&d)[kDigest], const Consts& c) {
  u64 s[kWidth];
#pragma unroll
  for (int j = 0; j < kDigest; ++j) {
    s[j] = via_l2 ? __ldcg(left + j) : left[j];
    s[kDigest + j] = via_l2 ? __ldcg(right + j) : right[j];
    s[2 * kDigest + j] = 0;
  }
  p2::permute(s, c);
#pragma unroll
  for (int j = 0; j < kDigest; ++j) d[j] = lz::canon(s[j]);
}

__global__ void __launch_bounds__(kThreads)
    hash_two_kernel(const u64* __restrict__ left, int64_t left_stride,
                    const u64* __restrict__ right, int64_t right_stride,
                    u64* __restrict__ out, int64_t n,
                    const __grid_constant__ Consts c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 d[kDigest];
  compress(left + i * left_stride, right + i * right_stride, false, d, c);
#pragma unroll
  for (int j = 0; j < kDigest; ++j) out[i * kDigest + j] = d[j];
}

constexpr int kMaxLevels = 63;

struct LevelOuts {
  u64* level[kMaxLevels];  // level j + 1 above the input: (K, n >> (j + 1), 4)
};

// The levels above `in` up to the root, every one at the width of a block.
// Block (x, y) first hashes nodes x·256 .. x·256 + 255 of tree y's level 1;
// after each level the block that finishes second of a pair of sibling
// groups (an atomic ticket, after a fence that publishes the group's
// digests) goes on to the 256 nodes above the pair, reading its sibling's
// digests through L2, and the other block exits.  Nothing waits on
// anything, every level but the last eight of a tree runs 256 threads a
// block, and a whole tree is one launch.  `tickets`: zeroed, one counter
// per pair of groups and level.
__global__ void __launch_bounds__(kThreads)
    merkle_levels_kernel(const u64* in, int64_t batch_stride,
                         int64_t row_stride, int64_t n, LevelOuts outs,
                         unsigned* __restrict__ tickets, int64_t tickets_per_tree,
                         const __grid_constant__ Consts c) {
  __shared__ unsigned last;
  const int t = threadIdx.x;
  const int64_t tree = blockIdx.y;
  int64_t group = blockIdx.x;
  int64_t width = n >> 1;  // nodes of the level being hashed, per tree
  unsigned* ticket = tickets + tree * tickets_per_tree;
  const u64* below = in + tree * batch_stride;  // the level under it
  int64_t stride = row_stride;
  for (int lv = 0; width > 0; ++lv) {
    const int64_t node = group * kThreads + t;
    if (node < width) {
      u64 d[kDigest];
      const u64* pair = below + 2 * node * stride;
      compress(pair, pair + stride, lv != 0, d, c);  // a level this launch wrote: via L2
      u64* out = outs.level[lv] + (tree * width + node) * kDigest;
#pragma unroll
      for (int j = 0; j < kDigest; ++j) out[j] = d[j];
    }
    if (width > kThreads) {  // two or more groups: meet the sibling
      __threadfence();
      __syncthreads();
      if (t == 0) last = atomicAdd(ticket + (group >> 1), 1u);
      __syncthreads();
      if (last == 0) return;  // the sibling goes on
      __threadfence();
      ticket += width / (2 * kThreads);  // this level's pairs of groups
      group >>= 1;
    } else {
      __syncthreads();  // this block wrote the whole level
    }
    below = outs.level[lv] + tree * width * kDigest;
    stride = kDigest;
    width >>= 1;
  }
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

// All pointers but `consts` and `outs` are device pointers to canonical
// 64-bit words; `consts` is a host pointer to the 153 words of `Consts`;
// strides count words.  Each function returns the cudaError_t of its launch
// (0 on success).

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

// in: `trees` levels of n digests of 4 contiguous words, digest i of tree y
// at y·batch_stride + i·row_stride; n a power of two, n >= 2.  outs: a host
// array of log2(n) device pointers, level j (from 1) a contiguous
// (trees, n >> j, 4) tensor.  tickets: `trees` x tickets_per_tree zeroed
// device words, tickets_per_tree >= max(1, n / 512).
extern "C" int ezt_poseidon2_merkle_levels(const void* in, long long batch_stride,
                                           long long row_stride, long long n,
                                           long long trees, const void* const* outs,
                                           void* tickets, long long tickets_per_tree,
                                           const void* consts, void* stream) {
  if (n < 2 || (n & (n - 1)) || trees < 1 || trees > 65535 || tickets_per_tree < (n >> 9))
    return static_cast<int>(cudaErrorInvalidValue);
  LevelOuts o{};
  int levels = 0;
  while ((n >> levels) > 1) ++levels;
  for (int j = 0; j < levels; ++j) o.level[j] = static_cast<u64*>(const_cast<void*>(outs[j]));
  const long long groups = (n / 2 + kThreads - 1) / kThreads;
  const dim3 blocks(static_cast<unsigned>(groups), static_cast<unsigned>(trees));
  merkle_levels_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), batch_stride, row_stride, n, o,
      static_cast<unsigned*>(tickets), tickets_per_tree, load_consts(consts));
  return static_cast<int>(cudaGetLastError());
}
