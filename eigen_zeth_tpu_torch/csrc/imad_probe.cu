// Probe of the card's rate for the multiply-add the field core is built
// from.  It measures; no kernel of the port calls it.
//
// Two register-only loops, nothing touching memory until one last store of a
// word that depends on every chain, so that none can be dropped:
//
//   mode 0  the multiply pipe alone: each thread keeps kWide independent
//           64-bit accumulators and adds a 32x32->64 product into each
//           (`mad.wide.u32`), `iters` times over.
//   mode 1  the field core: each thread walks kChains independent chains of
//           Montgomery products x <- x*y (ezt::mont_mul_fe: the
//           `mad.lo.cc` / `madc.hi.cc` chains, 136 multiply-adds a
//           product), `iters` products each.
//
// With enough blocks to fill every SM the time of mode 0 is the pipe's, and
// mode 1 shows how much of that rate a product keeps once its carry
// arithmetic shares the scheduler with it.

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

constexpr int kWide = 8;
constexpr int kChains = 2;
constexpr int kMadsPerProduct = 136;

__global__ void wide_probe_kernel(uint32_t* __restrict__ out, int iters,
                                  uint32_t seed) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t x = seed ^ (tid * 2654435761u);
  uint32_t y[kWide];
  unsigned long long acc[kWide];
#pragma unroll
  for (int c = 0; c < kWide; ++c) {
    y[c] = x * (2 * c + 3) + 1;
    acc[c] = x + c;
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kWide; ++c)
      asm volatile("mad.wide.u32 %0, %1, %2, %0;"
                   : "+l"(acc[c])
                   : "r"(x), "r"(y[c]));
  }
  unsigned long long r = 0;
#pragma unroll
  for (int c = 0; c < kWide; ++c) r ^= acc[c];
  out[tid] = static_cast<uint32_t>(r) ^ static_cast<uint32_t>(r >> 32);
}

__global__ void product_probe_kernel(uint32_t* __restrict__ out, int iters,
                                     uint32_t seed, ezt::Modulus m) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  ezt::Fe x[kChains], y;
#pragma unroll
  for (int k = 0; k < ezt::kWords; ++k) {
    y.w[k] = (seed ^ (tid * 2654435761u)) + k;
#pragma unroll
    for (int c = 0; c < kChains; ++c) x[c].w[k] = tid * (2 * c + 3) + k;
  }
  // below q (its top word is above 2^28), so every product is in range
  y.w[ezt::kWords - 1] &= 0x0FFFFFFFu;
#pragma unroll
  for (int c = 0; c < kChains; ++c) x[c].w[ezt::kWords - 1] &= 0x0FFFFFFFu;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) x[c] = ezt::mont_mul_fe(x[c], y, m);
  }
  uint32_t r = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
#pragma unroll
    for (int k = 0; k < ezt::kWords; ++k) r ^= x[c].w[k];
  out[tid] = r;
}

}  // namespace

// out: device pointer to blocks * threads uint32 words; q_words: host pointer
// to the modulus as 8 little-endian 32-bit words (mode 1).  `mads_per_thread`
// receives the multiply-adds one thread executes.  Returns the cudaError_t of
// the launch.
extern "C" int ezt_imad_probe(void* out, int mode, int blocks, int threads,
                              int iters, const void* q_words, unsigned n0,
                              long long* mads_per_thread, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<uint32_t*>(out);
  if (mode == 0) {
    *mads_per_thread = static_cast<long long>(iters) * kWide;
    wide_probe_kernel<<<blocks, threads, 0, s>>>(o, iters, 0x9E3779B9u);
  } else {
    *mads_per_thread =
        static_cast<long long>(iters) * kChains * kMadsPerProduct;
    product_probe_kernel<<<blocks, threads, 0, s>>>(
        o, iters, 0x9E3779B9u, ezt::make_modulus(q_words, n0));
  }
  return static_cast<int>(cudaGetLastError());
}
