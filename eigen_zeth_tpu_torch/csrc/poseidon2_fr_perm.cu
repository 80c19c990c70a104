// Kernel F's permutation entry, ezt_poseidon_fr_perm: (N, 12) canonical Fr
// states -> (N, 12), one thread a state.  The kernel's design and what bounds
// it: poseidon2_fr.cu; the core: poseidon2_fr.cuh.

#include "poseidon2_fr_launch.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
    perm_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe s[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) s[j] = fr::to_mont(load_words(in + (i * kWidth + j) * 4), c_fr);
  fr::permute(s, c_fr);
#pragma unroll
  for (int j = 0; j < kWidth; ++j) store_words(out + (i * kWidth + j) * 4, fr::from_mont(s[j]));
}

}  // namespace

// in, out: (n, 12, 4) contiguous words.
extern "C" int ezt_poseidon_fr_perm(const void* in, void* out, long long n,
                                    const void* q_words, unsigned n0, const void* consts,
                                    void* stream) {
  if (int rc = check_modulus(q_words, n0)) return rc;
  if (int rc = upload_consts(consts)) return rc;
  perm_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
