// Kernel A: batched Montgomery multiply out = a*b*2^-256 mod q, and the
// power out = a^e of a host-known exponent in one launch.
//
// Replaces the Pallas kernel `_mont_mul_kernel`
// (eigen_zeth_tpu/ops/pallas/mont_pl.py:30, entry `mont_mul_pallas` :95);
// `ezt_mont_pow` computes what eigen_zeth_tpu/ops/bigint.py:342
// (`MontCtx.mont_pow`, and `inv` :364 through it) computes with one launch
// of that kernel per squaring and per multiply.
//
// What bounds it on the H100.  A product moves 3 x 64 bytes of 16-bit limbs
// (two operands in, one out) for 136 multiply-adds: by the card's rates the
// bytes take longer, so a large batch is bound by device memory, and the
// kernel keeps every limb in registers for the whole product (one thread per
// element, no shared memory, coalesced limb-major loads, the modulus in the
// parameter bank).  But the callers' batches are small (20 to 42,432
// elements, at most a few MB): there the card needs a few microseconds and
// the host far longer to enqueue the launch, so what the paths pay for is the
// NUMBER of launches.  The largest source was Fermat inversion, 367 launches
// for one batch of 20 to 32 elements; `mont_pow_kernel` runs the whole
// square-and-multiply chain in registers instead.  The exponent is the same
// for every thread, so the branch on its bits never splits a warp; at these
// batches one warp per SM at most is busy and the kernel's time is the
// latency of about 380 dependent products, which no layout can hide.

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPowThreads = 64;  // small batches: spread them over more SMs

using ezt::Fe;
using ezt::Modulus;

struct Exponent {
  uint32_t w[ezt::kWords];
  int bits;  // position of the top set bit plus one; 0 for e = 0
};

__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    int32_t* __restrict__ out, int64_t n, Modulus m) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = ezt::load_fe(a, n, i);
  Fe y = ezt::load_fe(b, n, i);
  ezt::store_fe(out, n, i, ezt::mont_mul_fe(x, y, m));
}

// Left-to-right square and multiply: r = a at the top bit, then one squaring
// per lower bit and one multiply by a where the bit is set.
__global__ void __launch_bounds__(kPowThreads)
    mont_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                    int64_t n, Modulus m, Exponent e, Fe one) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (e.bits == 0) {
    ezt::store_fe(out, n, i, one);
    return;
  }
  const Fe x = ezt::load_fe(a, n, i);
  Fe r = x;
  for (int k = e.bits - 2; k >= 0; --k) {
    r = ezt::mont_sqr_fe(r, m);
    if ((e.w[k >> 5] >> (k & 31)) & 1u) r = ezt::mont_mul_fe(r, x, m);
  }
  ezt::store_fe(out, n, i, r);
}

}  // namespace

// a, b, out: device pointers to (16, n) int32 limb planes; q_words: host
// pointer to the modulus as 8 little-endian 32-bit words.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ezt_mont_mul(const void* a, const void* b, void* out,
                            long long n, const void* q_words, unsigned n0,
                            void* stream) {
  const Modulus m = ezt::make_modulus(q_words, n0);
  long long blocks = (n + kThreads - 1) / kThreads;
  mont_mul_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

// out = a^e in Montgomery form.  a, out: device pointers to (16, n) int32
// limb planes; q_words, exp_words, one_words: host pointers to the modulus,
// the exponent (below 2^256) and R mod q as 8 little-endian 32-bit words.
// a^0 = one for every a.  Returns the cudaError_t of the launch.
extern "C" int ezt_mont_pow(const void* a, void* out, long long n,
                            const void* q_words, unsigned n0,
                            const void* exp_words, const void* one_words,
                            void* stream) {
  const Modulus m = ezt::make_modulus(q_words, n0);
  Exponent e;
  std::memcpy(e.w, exp_words, sizeof(e.w));
  e.bits = 0;
  for (int k = 0; k < 32 * ezt::kWords; ++k)
    if ((e.w[k >> 5] >> (k & 31)) & 1u) e.bits = k + 1;
  Fe one;
  std::memcpy(one.w, one_words, sizeof(one.w));
  long long blocks = (n + kPowThreads - 1) / kPowThreads;
  mont_pow_kernel<<<static_cast<unsigned>(blocks), kPowThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<int32_t*>(out), n, m, e,
      one);
  return static_cast<int>(cudaGetLastError());
}
