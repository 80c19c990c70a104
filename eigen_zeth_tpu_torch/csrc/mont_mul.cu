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
// chain in registers instead.  At these batches one warp per SM at most is
// busy and the kernel's time is the latency of its dependent products, so
// the power is a sliding window over the exponent: the odd powers a, a^3,
// ..., a^(2^w - 1) of each element are made first and held in shared
// memory, laid out [entry][word][thread], then each window of the exponent
// costs its squarings and one product by a table entry.  The schedule (the
// squarings before each product and the entry it takes) is made on the host
// (ops/kernels.py: pow_schedule) and travels in the parameter bank; the
// exponent is the same for every thread, so every table read is
// warp-uniform and free of bank conflicts, and no branch splits a warp.
// For q - 2 the binary ladder's 253 squarings and 109 products become 253
// squarings and 55 products at w = 4 (252 squarings and 48 products over
// 49 windows, one squaring and 7 products for the table), 34,804
// multiply-adds an element where the ladder took 42,148; w = 5 takes 53
// products.  The width, 4, is scripts/tune_mont_pow.py's choice on an H100
// (700 W): 1.250 ms at (16, 2^18) against 1.285 ms at 5 bits, 0.334 ms at
// (16, 2^16) against 0.347 ms, 0.122 ms at 32 elements against 0.120 ms
// (the ladder: 1.62 ms and 0.148 ms).  Five bits' table of 16 entries
// (32 KB a block) halves the blocks an SM holds, and the fixed-base's 973
// launches at 2^16 outweigh the paths' 26 at 32 elements.

#include <cuda_runtime.h>

#include "bn254_field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPowThreads = 64;  // small batches: spread them over more SMs
constexpr int kPowMaxSteps = 72;   // ops/kernels.py: POW_MAX_STEPS
constexpr int kPowMaxTable = 16;   // odd powers up to a^31: windows of 5 bits
constexpr uint8_t kNoProduct = 0xFF;

using ezt::Fe;
using ezt::Modulus;

// A sliding-window chain (ops/kernels.py: PowSchedule, the same layout):
// r = table[entry[0]], then for each later step `squarings[k]` squarings
// and a product by table[entry[k]] (none for kNoProduct, the trailing
// zeros of the exponent).  table[j] = a^(2j + 1); `table` entries are made.
// steps = 0: the exponent is 0.
struct PowSchedule {
  int32_t steps;
  int32_t table;
  uint8_t squarings[kPowMaxSteps];
  uint8_t entry[kPowMaxSteps];
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

// Sliding-window power.  Each thread reads and writes only its own column
// of the table, so no barrier is needed.
__global__ void __launch_bounds__(kPowThreads)
    mont_pow_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                    int64_t n, Modulus m, const __grid_constant__ PowSchedule s,
                    Fe one) {
  extern __shared__ uint32_t table[];  // [entry][word][thread]
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (s.steps == 0) {
    ezt::store_fe(out, n, i, one);
    return;
  }
  uint32_t* mine = table + threadIdx.x;
  auto put = [&](int j, const Fe& v) {
#pragma unroll
    for (int k = 0; k < ezt::kWords; ++k) mine[(j * ezt::kWords + k) * kPowThreads] = v.w[k];
  };
  auto get = [&](int j) {
    Fe v;
#pragma unroll
    for (int k = 0; k < ezt::kWords; ++k) v.w[k] = mine[(j * ezt::kWords + k) * kPowThreads];
    return v;
  };
  const Fe x = ezt::load_fe(a, n, i);
  put(0, x);
  if (s.table > 1) {
    const Fe x2 = ezt::mont_sqr_fe(x, m);
    Fe v = x;
    for (int j = 1; j < s.table; ++j) {
      v = ezt::mont_mul_fe(v, x2, m);
      put(j, v);
    }
  }
  Fe r = get(s.entry[0]);
  for (int k = 1; k < s.steps; ++k) {
    for (int j = s.squarings[k]; j > 0; --j) r = ezt::mont_sqr_fe(r, m);
    if (s.entry[k] != kNoProduct) r = ezt::mont_mul_fe(r, get(s.entry[k]), m);
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
// limb planes; q_words, one_words: host pointers to the modulus and R mod q
// as 8 little-endian 32-bit words; schedule: host pointer to e's
// PowSchedule.  a^0 = one for every a.  Returns the cudaError_t of the
// launch, or cudaErrorInvalidValue for a schedule out of range.
extern "C" int ezt_mont_pow(const void* a, void* out, long long n,
                            const void* q_words, unsigned n0,
                            const void* schedule, const void* one_words,
                            void* stream) {
  const Modulus m = ezt::make_modulus(q_words, n0);
  PowSchedule s;
  std::memcpy(&s, schedule, sizeof(s));
  if (s.steps < 0 || s.steps > kPowMaxSteps || s.table < 1 || s.table > kPowMaxTable)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < s.steps; ++k)
    if (s.entry[k] >= s.table && !(k > 0 && s.entry[k] == kNoProduct))
      return static_cast<int>(cudaErrorInvalidValue);
  Fe one;
  std::memcpy(one.w, one_words, sizeof(one.w));
  long long blocks = (n + kPowThreads - 1) / kPowThreads;
  const size_t shared = static_cast<size_t>(s.steps ? s.table : 0) * ezt::kWords *
                        kPowThreads * sizeof(uint32_t);
  mont_pow_kernel<<<static_cast<unsigned>(blocks), kPowThreads, shared,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<int32_t*>(out), n, m, s,
      one);
  return static_cast<int>(cudaGetLastError());
}
