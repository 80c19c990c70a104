// Kernel A: batched Montgomery multiply out = a*b*2^-256 mod q.
//
// Replaces the Pallas kernel `_mont_mul_kernel`
// (eigen_zeth_tpu/ops/pallas/mont_pl.py:30, entry `mont_mul_pallas` :95).
//
// What bounds it on the H100: each element moves 3 x 64 bytes of 16-bit
// limbs (two operands in, one out) for 64 32x32->64 multiply-adds of the CIOS
// loop plus 64 for the reduction.  At the MSM's batch sizes (tens of
// thousands of elements) that is a few MB per launch, so launch latency and
// the int32 multiply pipe, not HBM, set the time.  The design keeps all
// limbs in registers for the whole CIOS loop (one thread per element, no
// shared memory, no intermediate ever written back) and reads the modulus
// from the parameter bank.  Any modulus works: MontCtx passes q and n0.

#include <cuda_runtime.h>

#include <cstring>

#include "bn254_field.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    int32_t* __restrict__ out, int64_t n, ezt::Modulus m) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  ezt::Fe x = ezt::load_fe(a, n, i);
  ezt::Fe y = ezt::load_fe(b, n, i);
  ezt::store_fe(out, n, i, ezt::mont_mul_fe(x, y, m));
}

}  // namespace

// a, b, out: device pointers to (16, n) int32 limb planes; q_words: host
// pointer to the modulus as 8 little-endian 32-bit words.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ezt_mont_mul(const void* a, const void* b, void* out,
                            long long n, const void* q_words, unsigned n0,
                            void* stream) {
  ezt::Modulus m;
  std::memcpy(m.q, q_words, sizeof(m.q));
  m.n0 = n0;
  long long blocks = (n + kThreads - 1) / kThreads;
  mont_mul_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}
