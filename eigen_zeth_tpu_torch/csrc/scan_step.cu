// Kernel C: one fused MSM phase-1 scan step.
//
// Replaces the Pallas kernel `_scan_step_kernel`
// (eigen_zeth_tpu/ops/pallas/ec_pl.py:242, entry `point_scan_step_pallas`
// :317).  Per element, with acc = (X1, Y1, Z1) Jacobian and (x, y) affine:
//
//     y'  = sign ? -y : y                  (digit sign; -0 = 0, as the XLA
//                                           mirror eigen_zeth_tpu/ops/msm.py:369)
//     new = acc +_unsafe (x, y', 1)        (madd-2007-bl, 7M + 4S)
//     out = flag ? (x, y', one) : new      (segment restart; one = R mod q)
//     bad = (H == 0 || Z1 == 0) && !flag   (collision detector)
//
// Under a flag the output does not depend on the accumulator at all, so the
// all-zero accumulator of the first serial step is a valid input.
//
// What bounds it on the H100: 524 bytes of limb traffic per element (five
// 64-byte planes and two 4-byte masks in, three planes and one mask out)
// against 11 Montgomery products, about 1,500 32-bit multiply-adds.  At the
// MSM's batch (20 windows x 8,192 lanes) the bytes take longer than the
// multiplies at the card's peak rates, so device memory is the bound, and
// the fusion is what serves it: the sign select, the add, the restart
// select and the flag are one pass over memory instead of four, every
// intermediate stays in registers, and the limb-major loads are coalesced.
// One thread per element; five inputs hold 40 words, so the block is capped
// at 128 threads and `-Xptxas -v` in the build log reports registers and
// spills.

#include <cuda_runtime.h>

#include <cstring>

#include "bn254_field.cuh"

namespace {

constexpr int kThreads = 128;

using ezt::Fe;
using ezt::Modulus;

__global__ void __launch_bounds__(kThreads)
    scan_step_kernel(const int32_t* __restrict__ ax,
                     const int32_t* __restrict__ ay,
                     const int32_t* __restrict__ az,
                     const int32_t* __restrict__ bx,
                     const int32_t* __restrict__ by,
                     const int32_t* __restrict__ sign,
                     const int32_t* __restrict__ flag,
                     int32_t* __restrict__ ox, int32_t* __restrict__ oy,
                     int32_t* __restrict__ oz, int32_t* __restrict__ bad,
                     int64_t n, Modulus m, Fe one) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  using namespace ezt;
  const bool negate = sign[i] != 0;
  const bool restart = flag[i] != 0;
  const Fe X1 = load_fe(ax, n, i), Y1 = load_fe(ay, n, i), Z1 = load_fe(az, n, i);
  const Fe X2 = load_fe(bx, n, i);
  Fe Y2 = load_fe(by, n, i);
  Y2 = select_fe(negate, neg_fe(Y2, m), Y2);

  Fe X3, Y3, Z3;
  const bool collide = madd_unsafe_fe(X1, Y1, Z1, X2, Y2, X3, Y3, Z3, m);

  store_fe(ox, n, i, select_fe(restart, X2, X3));
  store_fe(oy, n, i, select_fe(restart, Y2, Y3));
  store_fe(oz, n, i, select_fe(restart, one, Z3));
  bad[i] = (collide && !restart) ? 1 : 0;
}

}  // namespace

// acc = (ax, ay, az), point = (bx, by), out = (ox, oy, oz): device pointers
// to (16, n) int32 limb planes in Montgomery form; sign, flag, bad: device
// pointers to (n,) int32 masks (0 / non-zero in, 0 / 1 out).  q_words and
// one_words: host pointers to the modulus and to R mod q as 8 little-endian
// 32-bit words.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ezt_point_scan_step(const void* ax, const void* ay,
                                   const void* az, const void* bx,
                                   const void* by, const void* sign,
                                   const void* flag, void* ox, void* oy,
                                   void* oz, void* bad, long long n,
                                   const void* q_words, unsigned n0,
                                   const void* one_words, void* stream) {
  Modulus m;
  std::memcpy(m.q, q_words, sizeof(m.q));
  m.n0 = n0;
  Fe one;
  std::memcpy(one.w, one_words, sizeof(one.w));
  long long blocks = (n + kThreads - 1) / kThreads;
  scan_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ax), static_cast<const int32_t*>(ay),
      static_cast<const int32_t*>(az), static_cast<const int32_t*>(bx),
      static_cast<const int32_t*>(by), static_cast<const int32_t*>(sign),
      static_cast<const int32_t*>(flag), static_cast<int32_t*>(ox),
      static_cast<int32_t*>(oy), static_cast<int32_t*>(oz),
      static_cast<int32_t*>(bad), n, m, one);
  return static_cast<int>(cudaGetLastError());
}
