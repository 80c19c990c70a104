// Kernel F's launch side, shared by its three sources (poseidon2_fr.cu, the
// leaf sponge; poseidon2_fr_perm.cu, the permutation; poseidon2_fr_tree.cu,
// the tree): the constants in constant memory and their upload, the word
// conversions at the boundary, the block shape.  Each source is its own nvcc
// (one compiler an entry point, run together: the three fully unrolled
// permutations in one file took 90 s to compile) and gets its own copy.
// Pointers `in`, `out`, `tickets` and the level pointers of the entries are
// device pointers to 64-bit words; `q_words`, `cap_words` (an Fr value in
// Montgomery form) and `consts` (the words of fr::Consts,
// `kernels.poseidon_fr_const_words()`) are host pointers to little-endian
// 32-bit words.  `q_words` and `n0` must be r's (the core is built for r;
// anything else is refused with cudaErrorInvalidValue).  Each entry returns
// the cudaError_t of its launch (0 on success).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

#include "poseidon2_fr.cuh"

namespace {

namespace fr = ezt::fr;
using fr::Fe;

constexpr int kWidth = fr::kWidth;
constexpr int kRate = fr::kRate;
constexpr int kThreads = 128;  // a block; the tree's node groups (kernels.FR_TREE_THREADS)
constexpr int kMaxDevices = 64;

__constant__ fr::Consts c_fr;

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
    err = cudaMemcpyToSymbol(c_fr, words, sizeof(fr::Consts));
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

// The modulus a caller passes must be the one the core is built for.
int check_modulus(const void* q_words, unsigned n0) {
  uint32_t r[fr::kWords];
  for (int j = 0; j < fr::kWords; ++j) r[j] = fr::r_word(j);
  return std::memcmp(q_words, r, sizeof(r)) == 0 && n0 == fr::kN0
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
