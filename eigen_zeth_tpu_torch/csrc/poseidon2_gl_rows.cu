// Kernel E's verifier-rows entry: every Poseidon2 slot of the verifier AIR's
// trace (models/recursion.py), written in place into the trace on the card.
//
//   ezt_poseidon2_verifier_rows   a plan of Q queries x S slots -> the 48
//                                 columns (state, t^2, t^4, t^6) of the 32
//                                 rows of every slot of every period
//
// It replaces no TPU kernel: the JAX package builds these rows in host numpy
// (eigen_zeth_tpu/models/recursion.py:973), and so did the port, one slot for
// all queries a call, 147 calls an attestation at the node's chunk shape
// (4,096-row chunks, 32 queries, terminal 64), while the card waited: two
// thirds of the trace build, a third of an attestation.  The host keeps the
// plan (models/recursion.py `PermPlan`): for each query and slot the input
// state of a slot that starts a Merkle path or stands alone (the index
// chain's, the coefficient stream's), and for each later slot of a path the
// level's sibling and direction bit.
//
// What bounds it on the H100: the Merkle paths are serial in depth (up to 15
// permutations) but only (4 + R) x Q wide, 384 states at the node's shape,
// while the rows are 147 x 32 = 4,704 slots of 32 x 48 words, 57.8 MB, a
// bound of about 17 us at 3.35 TB/s; the arithmetic (about 1,700 products a
// slot) is small beside it at the card's width but not at one thread a path.
// So two kernels, one launch each, on one stream:
//
//   * `verifier_walk_kernel`, one thread per (path, query): the path's
//     permutations on E's lazy core (`permute`, digests only), each slot's
//     input state written back into the plan;
//   * `verifier_rows_kernel`, one thread per (query, slot): the slot's 30
//     rounds replayed (`rows::slot_rows`), each row's 48 canonical words
//     staged in shared memory and stored by the whole warp, so that 32 lanes
//     store neighbouring words of one 384-byte row and not 32 rows a word
//     each.
//
// The plan's words may be any 64-bit values (taken below p on reading);
// the trace's words are canonical, and equal the plain version's
// (`recursion._fill_perm_rows_plain`, the same plan walked with
// `_perm_rows_np`) bit for bit.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "poseidon2_gl_rows.cuh"

namespace {

using ezt::gl::u64;
namespace p2 = ezt::poseidon2;
namespace rw = ezt::poseidon2::rows;
using p2::Consts;
using p2::kWidth;

constexpr int kMaxChains = 64;
constexpr int kWalkThreads = 128;
constexpr int kWarp = 32;
constexpr int kStage = rw::kCols + 1;  // a staged row, padded: lanes' rows start in other banks

struct Chains {
  int n;
  int first[kMaxChains];  // the path's leaf slot
  int depth[kMaxChains];  // slots after it
};

__global__ void __launch_bounds__(kWalkThreads)
    verifier_walk_kernel(u64* __restrict__ plan, int64_t queries, int64_t slots,
                         const __grid_constant__ Chains chains, const __grid_constant__ Consts c) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= chains.n * queries) return;
  const int chain = static_cast<int>(i / queries);
  rw::walk_path(plan + ((i % queries) * slots + chains.first[chain]) * rw::kPlanWords,
                chains.depth[chain], c);
}

// Each lane's row into the warp's stage; after each row the warp stores the
// staged rows, lane l storing words l, l + 32, ... of them in order.
struct WarpSink {
  u64 (*stage)[kStage];
  const int64_t* base;  // each lane's slot: its row 0 in the trace
  u64* trace;
  int64_t row_stride;
  int lane, lanes;  // lanes: the warp's lanes that hold a slot

  __device__ __forceinline__ void put(int col, u64 v) { stage[lane][col] = v; }

  __device__ __forceinline__ void row(int r) {
    __syncwarp();
    for (int e = lane; e < lanes * rw::kCols; e += kWarp) {
      const int who = e / rw::kCols, col = e - who * rw::kCols;
      trace[base[who] + r * row_stride + col] = stage[who][col];
    }
    __syncwarp();
  }
};

__global__ void __launch_bounds__(kWarp)
    verifier_rows_kernel(u64* __restrict__ trace, int64_t row_stride, int64_t period,
                         const u64* __restrict__ plan, int64_t queries, int64_t slots,
                         const __grid_constant__ Consts c) {
  __shared__ u64 stage[kWarp][kStage];
  __shared__ int64_t base[kWarp];
  const int lane = threadIdx.x;
  const int64_t n = queries * slots;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarp;
  const int64_t i = first + lane;
  u64 s[kWidth];
  if (i < n) {
    const int64_t q = i / slots, slot = i % slots;
    base[lane] = (q * period + slot * rw::kRows) * row_stride;
    const u64* entry = plan + i * rw::kPlanWords;
#pragma unroll
    for (int j = 0; j < kWidth; ++j) s[j] = entry[j];
  } else {  // a lane past the end replays zeros and stores nothing
#pragma unroll
    for (int j = 0; j < kWidth; ++j) s[j] = 0;
  }
  const int lanes = static_cast<int>(n - first < kWarp ? n - first : kWarp);
  WarpSink sink{stage, base, trace, row_stride, lane, lanes};
  rw::slot_rows(s, c, sink);
}

inline unsigned blocks(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// trace: (queries·period, row_stride) canonical words on the card, slot j of
// query q at rows q·period + 32·j, its 48 words in columns 0..47 (the
// verifier AIR's Layout takes state, a2, a4 and a6 first).
// plan: (queries, slots, 17) words on the card (state, sibling, bit), the
// entries of every path slot after the first overwritten with its input
// state.  chains: a host array of n_chains (first slot, depth) pairs of
// long longs.  consts: kernel E's 153 constant words (host).  Returns the
// first cudaError_t of the two launches (0 on success).
extern "C" int ezt_poseidon2_verifier_rows(void* trace, long long row_stride, long long period,
                                           long long queries, long long slots, void* plan,
                                           const void* chains, long long n_chains,
                                           const void* consts, void* stream) {
  if (queries < 0 || slots < 0 || n_chains < 0 || n_chains > kMaxChains ||
      slots * rw::kRows > period || row_stride < rw::kCols)
    return static_cast<int>(cudaErrorInvalidValue);
  Chains ch{};
  ch.n = static_cast<int>(n_chains);
  const long long* pairs = static_cast<const long long*>(chains);
  for (int k = 0; k < ch.n; ++k) {
    const long long first = pairs[2 * k], depth = pairs[2 * k + 1];
    if (first < 0 || depth < 0 || first + depth >= slots)
      return static_cast<int>(cudaErrorInvalidValue);
    ch.first[k] = static_cast<int>(first);
    ch.depth[k] = static_cast<int>(depth);
  }
  if (queries == 0 || slots == 0) return 0;
  Consts c;
  std::memcpy(&c, consts, sizeof(c));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* p = static_cast<u64*>(plan);
  if (ch.n) {
    verifier_walk_kernel<<<blocks(ch.n * queries, kWalkThreads), kWalkThreads, 0, s>>>(
        p, queries, slots, ch, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  verifier_rows_kernel<<<blocks(queries * slots, kWarp), kWarp, 0, s>>>(
      static_cast<u64*>(trace), row_stride, period, p, queries, slots, c);
  return static_cast<int>(cudaGetLastError());
}
