// Kernel G: batched keccak256 (Ethereum's padding), one message per thread.
//
// Replaces, on the card, what the JAX package computes in
// eigen_zeth_tpu/ops/keccak.py:122 (`keccak_f`, the permutation over a batch
// of states as uint32 lane pairs, XLA code vectorized for the VPU) and :152
// (`keccak256`, the sponge over (N, L) same-length messages).
//
//   ezt_keccak256(in, n, nblocks, out, stream)
//     in:  (nblocks·17, n) uint64 lanes, lane-major: lane l of block b of
//          message i at in[(b·17 + l)·n + i], the messages already padded
//          (0x01 ... 0x80) on the caller's side
//     out: (4, n) uint64, the digest's four lanes, lane-major
//
// Each thread keeps its message's 25 lanes in registers and absorbs every
// block in the one launch; neighbouring threads read neighbouring words, so
// each absorbed lane is one coalesced load per warp.
//
// What bounds it on the H100: the integer pipes.  A block is 24 rounds of
// 64-bit XORs, ANDs with a NOT and 29 rotations; as 32-bit operations, with
// three-input logic (LOP3) and a rotation two funnel shifts, about 180 a
// round and 4,320 a block (KECCAK_OPS_PER_BLOCK in chip_smoke.py) for 136
// bytes read: some 30 operations a byte, where the memory's 3.35 TB/s
// against the 16.75 T 32-bit operations/s the bounds assume allows 5.  The
// design keeps the state out of memory (registers only, no shared memory),
// so the logic alone sets its time.

#include <cuda_runtime.h>

#include "keccak.cuh"

namespace {

namespace kc = ezt::keccak;
using kc::u64;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    keccak256_kernel(const u64* __restrict__ in, long long n, long long nblocks,
                     u64* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  u64 a[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) a[l] = 0;
  for (long long b = 0; b < nblocks; ++b) {
    const u64* blk = in + b * kc::kRateLanes * n + i;
#pragma unroll
    for (int l = 0; l < kc::kRateLanes; ++l) a[l] ^= blk[l * n];
    kc::permute(a);
  }
#pragma unroll
  for (int l = 0; l < kc::kDigestLanes; ++l) out[l * n + i] = a[l];
}

}  // namespace

// Returns the cudaError_t of the launch.
extern "C" int ezt_keccak256(const void* in, long long n, long long nblocks, void* out,
                             void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  keccak256_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), n, nblocks, static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}
