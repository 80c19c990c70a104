// Kernel B: complete Jacobian point add on the a = 0 curve, for G1 (over Fq)
// and G2 (over Fq2) from one source, with the scans' select inside.
//
// Replaces the Pallas kernel `_point_add_kernel`
// (eigen_zeth_tpu/ops/pallas/ec_pl.py:118, entry `point_add_pallas` :404).
// Same function as eigen_zeth_tpu/ops/bn254.py:206 `point_add`: infinity is
// z == 0, and doubling, infinity and P == -Q are resolved per element.
// `ezt_point_add_g2` is that function over `Fq2Ops`
// (eigen_zeth_tpu/ops/bn254.py:117), which the JAX package reaches from
// `msm_g2` (eigen_zeth_tpu/ops/msm.py:1036) with every Fq product a launch
// of the Montgomery-multiply kernel.
//
// With a mask, element i of the output is operand p (keep = 0) or q
// (keep = 1) with its limbs unchanged where mask[i] != 0, whatever the add
// would have given: `select(mask, kept, add(p, q))`, the form every add of
// the MSM scans has.  So an all-zero accumulator is a valid operand there.
//
// What bounds it on the H100: the integer multiply pipe.  The generic add
// (add-2007-bl with Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2)*H) is 11 products and 5
// squarings over 9 x 64 bytes of limb traffic (G2: the same count of Fq2
// operations over 18 x 64 bytes).  The design:
//
//   * the field core of bn254_field.cuh: two carry chains in flight per
//     thread, a dedicated squaring;
//   * the doubling (dbl-2009-l, 2 products and 5 squarings) runs only in a
//     warp where the vote finds a lane with H == 0, R == 0 and neither
//     operand at infinity, which in an MSM is rare; the branch is the same
//     for the whole warp, and each lane still takes the result its own
//     flags select;
//   * a warp whose lanes all pass an operand through does no arithmetic,
//     and a lane that passes an operand (by the mask or because the other
//     is at infinity) reads it again at the end and stores with the rest of
//     its warp, so every output line is written once;
//   * registers are the limit.  Operands are loaded where they are first
//     used, and the operand an infinity passes through is read again at the
//     end instead of being held.  G1, one lane a point: `__launch_bounds__`
//     asks for 4 blocks of 128 threads per SM, 128 registers with a few
//     dozen bytes of spills.  Measured at 2^18 pairs on an H100
//     (scripts/tune_point_add.py): 0.100 ms so, 0.105 ms at 148 registers
//     without spills (2 or 3 blocks of 128, 4 or 6 of 64), 0.131 ms with
//     one block of 256, 0.111 ms at 80 registers;
//   * G2 runs on two lanes a point (`Fq2Lanes`): a lane holds one component
//     of each Fq2 coordinate, six Fq inputs as G1 does, and an Fq2 product
//     is on each lane a sum of two products with one reduction, 200
//     multiply-adds a lane, 400 a pair where Karatsuba over full products
//     took 408 on one lane; a squaring is one product a lane.  A pair has
//     both lanes take the same branch: its mask, its infinities and its
//     flags are the pair's.  One lane a point (six Fq2 inputs, 96 words,
//     and Karatsuba's three reductions) could not have both occupancy and
//     no spills: 0.487 ms at 128 registers with 1.5 KB of spills, 0.56 ms
//     at 168 without, 0.62-0.65 ms at 96 and at the 255 cap.  Two lanes
//     still need about 170 registers: the first two-lane form, which took
//     the partner's b whole, ran 0.243 ms at 128 registers with 44 bytes of
//     spills, 0.254 ms at 168 with 40 and 0.299 ms at 194 without
//     (scripts/tune_point_add.py, H100 at 700 W); reordering the add's
//     products or the doubling did not remove them.  Taking b one word a
//     round instead (mont_mul2_lanes) removes them at 3 blocks of 128 per
//     SM (EZT_ADD_G2_LANE_BLOCKS): 166 registers, 0.2534 ms.  Three blocks
//     are chosen to have no spills, not for speed: the same code at 4
//     blocks spills 72 bytes and runs 0.2476 ms, and the first two-lane
//     form at 4 blocks 0.2437 ms (H100 at 700 W, the tuning script's
//     table), 2-4% faster; a redesign that frees registers starts there.

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

// Block size and blocks per SM that `__launch_bounds__` asks for; the build
// may set them to compare variants (scripts/tune_point_add.py).
#ifndef EZT_ADD_THREADS
#define EZT_ADD_THREADS 128
#endif
#ifndef EZT_ADD_G1_BLOCKS
#define EZT_ADD_G1_BLOCKS 4
#endif
#ifndef EZT_ADD_G2_LANE_BLOCKS
#define EZT_ADD_G2_LANE_BLOCKS 3
#endif

constexpr int kThreads = EZT_ADD_THREADS;

using ezt::kFullWarp;
using ezt::Modulus;

// Limb-plane pointers of one launch: p = (x, y, z), q = (x, y, z), out =
// (x, y, z), each coordinate F::kPlanes planes of (16, n) int32.  Element i
// is on F::kLanes neighbouring lanes.
template <class F>
struct PointArgs {
  const int32_t* p[3][F::kPlanes];
  const int32_t* q[3][F::kPlanes];
  int32_t* out[3][F::kPlanes];
  const int32_t* mask;  // (n,) or null
  int keep;             // with a mask: 0 passes p, 1 passes q
};

// The sum of the lane's pair of points into (X3, Y3, Z3), for every lane of a
// warp at once (the votes and Fq2Lanes' shuffles need all 32 lanes).  Lanes without `work` run on
// zeros.  Returns 0 where the sum stands, 1 where operand p passes (q at
// infinity), 2 where q passes (p at infinity; inf + inf = q, an infinity
// too).
template <class F>
__device__ __forceinline__ int add_warp(const PointArgs<F>& args, int64_t n,
                                        int64_t i, bool work, const Modulus& m,
                                        typename F::El& X3, typename F::El& Y3,
                                        typename F::El& Z3) {
  using El = typename F::El;
  auto load = [&](const int32_t* const* planes) {
    return work ? F::load(planes, n, i) : F::zero();
  };
  const El Z1 = load(args.p[2]), Z2 = load(args.q[2]);
  const bool p_inf = F::is_zero(Z1);
  const bool q_inf = F::is_zero(Z2);
  const El z1z1 = F::sqr(Z1, m);
  const El z2z2 = F::sqr(Z2, m);
  // 2*Z1*Z2 as (Z1 + Z2)^2 - Z1Z1 - Z2Z2: a squaring for a product
  const El zz = F::sub(F::sub(F::sqr(F::add(Z1, Z2, m), m), z1z1, m), z2z2, m);
  const El u1 = F::mul(load(args.p[0]), z2z2, m);
  const El h = F::sub(F::mul(load(args.q[0]), z1z1, m), u1, m);
  const El s1 = F::mul(F::mul(load(args.p[1]), Z2, m), z2z2, m);
  const El rr = F::sub(F::mul(F::mul(load(args.q[1]), Z1, m), z1z1, m), s1, m);

  const bool h_zero = F::is_zero(h);
  const bool r_zero = F::is_zero(rr);
  const bool both = work && !p_inf && !q_inf;
  const bool use_dbl = both && h_zero && r_zero;
  const bool make_inf = both && h_zero && !r_zero;

  // generic add (add-2007-bl)
  Z3 = F::mul(zz, h, m);
  const El i_ = F::sqr(F::dbl(h, m), m);
  const El j_ = F::mul(h, i_, m);
  const El r2 = F::dbl(rr, m);
  const El v = F::mul(u1, i_, m);
  X3 = F::sub(F::sub(F::sqr(r2, m), j_, m), F::dbl(v, m), m);
  Y3 = F::sub(F::mul(r2, F::sub(v, X3, m), m), F::dbl(F::mul(s1, j_, m), m),
              m);

  if (__any_sync(kFullWarp, use_dbl)) {
    // doubling of p (dbl-2009-l, a = 0), operands read again
    const El X1 = load(args.p[0]), Y1 = load(args.p[1]);
    const El A = F::sqr(X1, m);
    const El B = F::sqr(Y1, m);
    const El C = F::sqr(B, m);
    const El t = F::sqr(F::add(X1, B, m), m);
    const El D = F::dbl(F::sub(F::sub(t, A, m), C, m), m);
    const El E = F::add(F::dbl(A, m), A, m);
    const El xd = F::sub(F::sqr(E, m), F::dbl(D, m), m);
    const El c8 = F::dbl(F::dbl(F::dbl(C, m), m), m);
    const El yd = F::sub(F::mul(E, F::sub(D, xd, m), m), c8, m);
    const El zd = F::dbl(F::mul(Y1, load(args.p[2]), m), m);
    X3 = F::select(use_dbl, xd, X3);
    Y3 = F::select(use_dbl, yd, Y3);
    Z3 = F::select(use_dbl, zd, Z3);
  }
  Z3 = F::select(make_inf, F::zero(), Z3);
  return p_inf ? 2 : (q_inf ? 1 : 0);
}

template <class F, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    point_add_kernel(PointArgs<F> args, int64_t n, Modulus m) {
  using El = typename F::El;
  static_assert(F::kLanes == 1 || F::kLanes == 2, "one or two lanes a point");
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t i = F::kLanes == 1 ? t : t >> 1;
  const bool active = i < n;
  const bool pass = active && args.mask != nullptr && args.mask[i] != 0;
  const bool work = active && !pass;
  El X3 = F::zero(), Y3 = F::zero(), Z3 = F::zero();
  int passes = pass ? 1 + (args.keep != 0) : 0;  // 0 none, 1 p, 2 q
  // every lane of the warp reaches the votes, in or out of range
  if (__any_sync(kFullWarp, work)) {
    const int inf = add_warp<F>(args, n, i, work, m, X3, Y3, Z3);
    if (work) passes = inf;
  }
  if (!active) return;
  if (passes != 0) {
    // the operand that passes is read again (limbs of 16 bits come back as
    // they went in), so that the lane stores with the rest of its warp
    const int32_t* src[3][F::kPlanes];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < F::kPlanes; ++k)
        src[c][k] = passes == 2 ? args.q[c][k] : args.p[c][k];
    X3 = F::load(src[0], n, i);
    Y3 = F::load(src[1], n, i);
    Z3 = F::load(src[2], n, i);
  }
  F::store(args.out[0], n, i, X3);
  F::store(args.out[1], n, i, Y3);
  F::store(args.out[2], n, i, Z3);
}

template <class F, int kMinBlocks>
int launch(const void* const* p, const void* const* q, void* const* out,
           const void* mask, int keep, long long n, const void* q_words,
           unsigned n0, void* stream) {
  PointArgs<F> args;
  for (int c = 0; c < 3; ++c)
    for (int k = 0; k < F::kPlanes; ++k) {
      const int at = c * F::kPlanes + k;
      args.p[c][k] = static_cast<const int32_t*>(p[at]);
      args.q[c][k] = static_cast<const int32_t*>(q[at]);
      args.out[c][k] = static_cast<int32_t*>(out[at]);
    }
  args.mask = static_cast<const int32_t*>(mask);
  args.keep = keep;
  long long blocks = (n * F::kLanes + kThreads - 1) / kThreads;
  point_add_kernel<F, kMinBlocks>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(args, n,
                                              ezt::make_modulus(q_words, n0));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// G1.  p = (ax, ay, az), q = (bx, by, bz), out = (ox, oy, oz): device
// pointers to (16, n) int32 limb planes in Montgomery form; q_words: host
// pointer to the field modulus as 8 little-endian 32-bit words; mask: device
// pointer to an (n,) int32 mask or null; keep: which operand a set mask
// passes (0 = p, 1 = q).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ezt_point_add(const void* ax, const void* ay, const void* az,
                             const void* bx, const void* by, const void* bz,
                             void* ox, void* oy, void* oz, long long n,
                             const void* q_words, unsigned n0,
                             const void* mask, int keep, void* stream) {
  const void* p[3] = {ax, ay, az};
  const void* q[3] = {bx, by, bz};
  void* out[3] = {ox, oy, oz};
  return launch<ezt::FqField, EZT_ADD_G1_BLOCKS>(p, q, out, mask, keep, n, q_words, n0, stream);
}

// G2.  planes: 18 device pointers to (16, n) int32 limb planes, in the order
// p.x.c0, p.x.c1, p.y.c0, p.y.c1, p.z.c0, p.z.c1, then q's six, then the six
// of the output.  The modulus must lie below 2^254.  The rest as for G1.
extern "C" int ezt_point_add_g2(const void* const* planes, long long n,
                                const void* q_words, unsigned n0,
                                const void* mask, int keep, void* stream) {
  return launch<ezt::Fq2Lanes, EZT_ADD_G2_LANE_BLOCKS>(
      planes, planes + 6, const_cast<void* const*>(planes + 12), mask, keep, n,
      q_words, n0, stream);
}
