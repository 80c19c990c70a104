// Kernel D: unsafe mixed add acc + (x, y, 1), with the `bad` plane.
//
// Replaces the Pallas kernel `_point_madd_kernel`
// (eigen_zeth_tpu/ops/pallas/ec_pl.py:186, entry `point_madd_pallas` :354).
// Same function as eigen_zeth_tpu/ops/bn254.py:point_madd_unsafe:
// madd-2007-bl with Z2 = 1 (7M + 4S), no doubling and no infinity branch;
// bad = 1 where H == 0 or Z1 == 0 (P == +-Q, or the accumulator at
// infinity), and there the three output planes are meaningless.  Unlike the
// scan step (kernel C) nothing masks `bad` here.
//
// What bounds it on the H100: 516 bytes of limb traffic per element (five
// 64-byte planes in, three planes and a 4-byte mask out) against 11
// Montgomery products, about 1,500 32-bit multiply-adds: at the card's peak
// rates the bytes take longer, so device memory is the bound.  The design is
// kernel C's without the selects: one thread per element, all intermediates
// in registers, one pass over memory, coalesced limb-major loads, blocks of
// 128 threads; `-Xptxas -v` in the build log reports registers and spills.

#include <cuda_runtime.h>

#include <cstring>

#include "bn254_field.cuh"

namespace {

constexpr int kThreads = 128;

using ezt::Fe;
using ezt::Modulus;

__global__ void __launch_bounds__(kThreads)
    point_madd_kernel(const int32_t* __restrict__ ax,
                      const int32_t* __restrict__ ay,
                      const int32_t* __restrict__ az,
                      const int32_t* __restrict__ bx,
                      const int32_t* __restrict__ by,
                      int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                      int32_t* __restrict__ oz, int32_t* __restrict__ bad,
                      int64_t n, Modulus m) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  using namespace ezt;
  const Fe X1 = load_fe(ax, n, i), Y1 = load_fe(ay, n, i), Z1 = load_fe(az, n, i);
  const Fe X2 = load_fe(bx, n, i), Y2 = load_fe(by, n, i);

  Fe X3, Y3, Z3;
  const bool collide = madd_unsafe_fe(X1, Y1, Z1, X2, Y2, X3, Y3, Z3, m);

  store_fe(ox, n, i, X3);
  store_fe(oy, n, i, Y3);
  store_fe(oz, n, i, Z3);
  bad[i] = collide ? 1 : 0;
}

}  // namespace

// acc = (ax, ay, az), point = (bx, by), out = (ox, oy, oz): device pointers
// to (16, n) int32 limb planes in Montgomery form; bad: device pointer to an
// (n,) int32 mask.  q_words: host pointer to the modulus as 8 little-endian
// 32-bit words.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ezt_point_madd(const void* ax, const void* ay, const void* az,
                              const void* bx, const void* by, void* ox,
                              void* oy, void* oz, void* bad, long long n,
                              const void* q_words, unsigned n0, void* stream) {
  Modulus m;
  std::memcpy(m.q, q_words, sizeof(m.q));
  m.n0 = n0;
  long long blocks = (n + kThreads - 1) / kThreads;
  point_madd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ax), static_cast<const int32_t*>(ay),
      static_cast<const int32_t*>(az), static_cast<const int32_t*>(bx),
      static_cast<const int32_t*>(by), static_cast<int32_t*>(ox),
      static_cast<int32_t*>(oy), static_cast<int32_t*>(oz),
      static_cast<int32_t*>(bad), n, m);
  return static_cast<int>(cudaGetLastError());
}
