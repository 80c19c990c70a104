// Kernel B: complete, branch-free Jacobian point add on the a = 0 curve.
//
// Replaces the Pallas kernel `_point_add_kernel`
// (eigen_zeth_tpu/ops/pallas/ec_pl.py:118, entry `point_add_pallas` :404).
// Same function as eigen_zeth_tpu/ops/bn254.py:point_add: infinity is
// z == 0, and doubling, infinity and P == -Q are resolved by selects, so
// every thread runs the same instruction stream.
//
// What bounds it on the H100: ~34 Montgomery multiplies per add (the generic
// path and the doubling path are both computed, as on the TPU) against
// 9 x 64 bytes of limb traffic, so it is bound by the integer multiply pipe
// and, above all, by registers: six inputs alone hold 48 words.  The design
// keeps one point pair per thread entirely in registers (no shared memory,
// every intermediate stays on chip, one pass over device memory) and caps
// the block at 128 threads so the launch fits the register file whatever
// ptxas allocates; `-Xptxas -v` in the build log reports registers and
// spills.

#include <cuda_runtime.h>

#include <cstring>

#include "bn254_field.cuh"

namespace {

constexpr int kThreads = 128;

using ezt::Fe;
using ezt::Modulus;

__global__ void __launch_bounds__(kThreads)
    point_add_kernel(const int32_t* __restrict__ ax,
                     const int32_t* __restrict__ ay,
                     const int32_t* __restrict__ az,
                     const int32_t* __restrict__ bx,
                     const int32_t* __restrict__ by,
                     const int32_t* __restrict__ bz, int32_t* __restrict__ ox,
                     int32_t* __restrict__ oy, int32_t* __restrict__ oz,
                     int64_t n, Modulus m) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  using namespace ezt;
  const Fe X1 = load_fe(ax, n, i), Y1 = load_fe(ay, n, i), Z1 = load_fe(az, n, i);
  const Fe X2 = load_fe(bx, n, i), Y2 = load_fe(by, n, i), Z2 = load_fe(bz, n, i);

  const Fe z1z1 = mont_mul_fe(Z1, Z1, m);
  const Fe z2z2 = mont_mul_fe(Z2, Z2, m);
  const Fe u1 = mont_mul_fe(X1, z2z2, m);
  const Fe u2 = mont_mul_fe(X2, z1z1, m);
  const Fe s1 = mont_mul_fe(mont_mul_fe(Y1, Z2, m), z2z2, m);
  const Fe s2 = mont_mul_fe(mont_mul_fe(Y2, Z1, m), z1z1, m);
  const Fe h = sub_fe(u2, u1, m);
  const Fe rr = sub_fe(s2, s1, m);

  const bool h_zero = is_zero_fe(h);
  const bool r_zero = is_zero_fe(rr);
  const bool p_inf = is_zero_fe(Z1);
  const bool q_inf = is_zero_fe(Z2);

  // generic add (add-2007-bl with z3 = 2*Z1*Z2*h)
  const Fe h2 = dbl_fe(h, m);
  const Fe i_ = mont_mul_fe(h2, h2, m);
  const Fe j_ = mont_mul_fe(h, i_, m);
  const Fe r2 = dbl_fe(rr, m);
  const Fe v = mont_mul_fe(u1, i_, m);
  const Fe x3 = sub_fe(sub_fe(mont_mul_fe(r2, r2, m), j_, m), dbl_fe(v, m), m);
  const Fe y3 = sub_fe(mont_mul_fe(r2, sub_fe(v, x3, m), m),
                       dbl_fe(mont_mul_fe(s1, j_, m), m), m);
  const Fe z3 = mont_mul_fe(dbl_fe(mont_mul_fe(Z1, Z2, m), m), h, m);

  // doubling (dbl-2009-l, a = 0)
  const Fe A = mont_mul_fe(X1, X1, m);
  const Fe B = mont_mul_fe(Y1, Y1, m);
  const Fe C = mont_mul_fe(B, B, m);
  const Fe xb = add_fe(X1, B, m);
  const Fe t = mont_mul_fe(xb, xb, m);
  const Fe D = dbl_fe(sub_fe(sub_fe(t, A, m), C, m), m);
  const Fe E = add_fe(dbl_fe(A, m), A, m);
  const Fe F = mont_mul_fe(E, E, m);
  const Fe xd = sub_fe(F, dbl_fe(D, m), m);
  const Fe c8 = dbl_fe(dbl_fe(dbl_fe(C, m), m), m);
  const Fe yd = sub_fe(mont_mul_fe(E, sub_fe(D, xd, m), m), c8, m);
  const Fe zd = dbl_fe(mont_mul_fe(Y1, Z1, m), m);

  const bool use_dbl = h_zero && r_zero && !p_inf && !q_inf;
  const bool make_inf = h_zero && !r_zero && !p_inf && !q_inf;
  const bool q_only = q_inf && !p_inf;

  Fe X3 = select_fe(use_dbl, xd, x3);
  Fe Y3 = select_fe(use_dbl, yd, y3);
  Fe Z3 = select_fe(use_dbl, zd, z3);
  Z3 = select_fe(make_inf, zero_fe(), Z3);
  X3 = select_fe(p_inf, X2, select_fe(q_only, X1, X3));
  Y3 = select_fe(p_inf, Y2, select_fe(q_only, Y1, Y3));
  Z3 = select_fe(p_inf, Z2, select_fe(q_only, Z1, Z3));

  store_fe(ox, n, i, X3);
  store_fe(oy, n, i, Y3);
  store_fe(oz, n, i, Z3);
}

}  // namespace

// p = (ax, ay, az), q = (bx, by, bz), out = (ox, oy, oz): device pointers to
// (16, n) int32 limb planes in Montgomery form; q_words: host pointer to the
// field modulus as 8 little-endian 32-bit words.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int ezt_point_add(const void* ax, const void* ay, const void* az,
                             const void* bx, const void* by, const void* bz,
                             void* ox, void* oy, void* oz, long long n,
                             const void* q_words, unsigned n0, void* stream) {
  Modulus m;
  std::memcpy(m.q, q_words, sizeof(m.q));
  m.n0 = n0;
  long long blocks = (n + kThreads - 1) / kThreads;
  point_add_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ax), static_cast<const int32_t*>(ay),
      static_cast<const int32_t*>(az), static_cast<const int32_t*>(bx),
      static_cast<const int32_t*>(by), static_cast<const int32_t*>(bz),
      static_cast<int32_t*>(ox), static_cast<int32_t*>(oy),
      static_cast<int32_t*>(oz), n, m);
  return static_cast<int>(cudaGetLastError());
}
