// Kernel F's tree entry, ezt_poseidon_fr_merkle_levels: every Merkle level
// above N leaf digests in one launch.  The kernel's design and what bounds
// it: poseidon2_fr.cu; the core: poseidon2_fr.cuh.

#include "poseidon2_fr_launch.cuh"

namespace {

// The 2-to-1 compression: lanes 0, 1 the children, lane 11 the node tag;
// `via_l2` reads the children past this SM's L1 (another block wrote them).
__device__ __forceinline__ Fe compress(const uint64_t* left, const uint64_t* right, bool via_l2,
                                       const Fe& cap) {
  uint64_t w[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = via_l2 ? __ldcg(left + j) : left[j];
    w[4 + j] = via_l2 ? __ldcg(right + j) : right[j];
  }
  Fe s[kWidth];
  s[0] = fr::to_mont(load_words(w), c_fr);
  s[1] = fr::to_mont(load_words(w + 4), c_fr);
#pragma unroll
  for (int j = 2; j < kWidth - 1; ++j) s[j] = fr::zero();
  s[kWidth - 1] = cap;
  fr::permute(s, c_fr);
  return fr::from_mont(s[0]);
}

constexpr int kMaxLevels = 63;

struct LevelOuts {
  uint64_t* level[kMaxLevels];  // level j + 1 above the leaves: (n >> (j + 1), 4)
};

// Every level above the n leaf digests `in` (contiguous (n, 4) words), at
// the width of a block: block x first hashes nodes x·128 .. x·128 + 127 of
// level 1; after each level the block that finishes second of a pair of
// sibling groups (an atomic ticket after a fence that publishes the
// group's digests) goes on to the nodes above the pair, the other exits.
// `tickets`: zeroed, one counter per pair of groups and level.
__global__ void __launch_bounds__(kThreads)
    merkle_levels_kernel(const uint64_t* in, int64_t n, LevelOuts outs,
                         unsigned* __restrict__ tickets, Fe cap) {
  __shared__ unsigned last;
  const int t = threadIdx.x;
  int64_t group = blockIdx.x;
  int64_t width = n >> 1;
  unsigned* ticket = tickets;
  const uint64_t* below = in;
  for (int lv = 0; width > 0; ++lv) {
    const int64_t node = group * kThreads + t;
    if (node < width) {
      const uint64_t* pair = below + 2 * node * 4;
      store_words(outs.level[lv] + node * 4, compress(pair, pair + 4, lv != 0, cap));
    }
    if (width > kThreads) {  // two or more groups: meet the sibling
      __threadfence();
      __syncthreads();
      if (t == 0) last = atomicAdd(ticket + (group >> 1), 1u);
      __syncthreads();
      if (last == 0) return;  // the sibling goes on
      __threadfence();
      ticket += width / (2 * kThreads);
      group >>= 1;
    } else {
      __syncthreads();  // this block wrote the whole level
    }
    below = outs.level[lv];
    width >>= 1;
  }
}

}  // namespace

// in: (n, 4) contiguous leaf digests, n a power of two, n >= 2; outs: a host
// array of log2(n) device pointers, level j (from 1) a contiguous
// (n >> j, 4) tensor; tickets: max(1, n / 256) zeroed device words.
extern "C" int ezt_poseidon_fr_merkle_levels(const void* in, long long n,
                                             const void* const* outs, void* tickets,
                                             const void* cap_words, const void* q_words,
                                             unsigned n0, const void* consts, void* stream) {
  if (n < 2 || (n & (n - 1))) return static_cast<int>(cudaErrorInvalidValue);
  if (int rc = check_modulus(q_words, n0)) return rc;
  if (int rc = upload_consts(consts)) return rc;
  LevelOuts o{};
  int levels = 0;
  while ((n >> levels) > 1) ++levels;
  for (int j = 0; j < levels; ++j) o.level[j] = static_cast<uint64_t*>(const_cast<void*>(outs[j]));
  const long long groups = (n / 2 + kThreads - 1) / kThreads;
  merkle_levels_kernel<<<static_cast<unsigned>(groups), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), n, o, static_cast<unsigned*>(tickets),
      fe_of(cap_words));
  return static_cast<int>(cudaGetLastError());
}
