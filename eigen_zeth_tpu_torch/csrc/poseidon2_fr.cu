// Kernel F: Poseidon2 over BN254 Fr (t = 12, x^5, 4 + 68 + 4 rounds, M_E =
// circ(2·M4, M4, M4), M_I = 1 + diag(mu), rate 11, capacity 1, a digest of
// one Fr element), one thread per state, on the lazy Montgomery core of
// poseidon2_fr.cuh (eight 32-bit words an element, R = 2^256, r a
// compile-time constant).
//
// Replaces, on the card, what the JAX package computes in
// eigen_zeth_tpu/ops/poseidon_fr.py:271-309 (`_perm_device_run`,
// `perm_device`: every product a `MontCtx.mont_mul`, which is the Pallas
// kernel A on the TPU) and the device Merkle commit built on it,
// eigen_zeth_tpu/models/merkle_fr.py:95-131 (`_leaf_digests_device`,
// `_compress_level_device`), whose place its host C++ engine took
// (merkle_fr.py:140-160).  Three entry points:
//
//   ezt_poseidon_fr_perm           (N, 12) states -> (N, 12)
//   ezt_poseidon_fr_hash_rows      (N, k) Goldilocks rows -> (N,) digests:
//                                  packed 3 to an Fr element as the rows
//                                  lie (any strides), the leaf sponge of a
//                                  row in one thread
//   ezt_poseidon_fr_merkle_levels  N leaf digests -> every level above
//                                  (a whole tree) in one launch
//
// An Fr value at the boundary is four 64-bit words, little end first,
// canonical, in regular form; the kernel enters Montgomery form with one
// product by R^2 and leaves it with one product by 1 and one conditional
// subtraction.  Between the two, values stay in the lazy ranges that
// poseidon2_fr.cuh states and proves: no add and no product is reduced to
// [0, r), a linear layer reduces each lane once.
//
// What bounds it on the H100: the integer multiply pipe.  A permutation is
// 980 products and 328 squarings (8 full rounds x 12 S-boxes x (2
// squarings + 1 product); 68 partial rounds x (2 squarings + 1 product + 12
// diagonal products)), 151,568 multiply-adds with the 816 diagonal products
// done as products by a constant (168,704 with every product a Montgomery
// one; this core does 152,996: lane 0's diagonal product is a Montgomery one,
// which keeps lane 0's S-box inside its range), against at most a few
// hundred bytes moved.  The design gives that pipe as few other
// instructions as it can: no compare and select in the lazy ranges, one
// reduction a linear layer, Shoup's product for 11 of the 12 diagonal
// products of a partial round (they do not depend on one another, so
// several carry chains are in flight), r and n0 as immediates, the round
// constants and the diagonal in constant memory (one uniform address a
// warp), and the sponge reads its 11 packed inputs only when it absorbs
// them.  Registers: the twelve lanes take 96.  A budget of 168 registers a
// thread (three blocks of 128 an SM) made ptxas spill 100-300 bytes a kernel
// and the sponge run slower (PERF.md), so the kernels give ptxas no
// register budget (`__launch_bounds__(kThreads)`): it takes 184-190
// registers and spills nothing, and an SM holds two blocks of 128 threads
// (eight warps, two a scheduler).  The tree entry is kernel E's: every level at the width
// of a block, the block that finishes second of a sibling pair (an atomic
// ticket after a fence) going on to the level above, so nothing waits and a
// tree is one launch; the levels narrower than the card's resident threads
// each cost one permutation's latency, and a single block would run them
// one after another in each thread instead.  No shared memory and no tensor
// cores: the work is carry chains of 32-bit multiply-adds whose quotients
// depend on the product itself (PERF.md gives the arithmetic).
//
// Outputs equal the plain version's (ops/poseidon_fr.py) bit for bit.
//
// This file holds the leaf sponge; poseidon2_fr_perm.cu the permutation,
// poseidon2_fr_tree.cu the tree, poseidon2_fr_launch.cuh what they share.

#include "poseidon2_fr_launch.cuh"

namespace {

// The leaf sponge of row i: packed element e holds the row's Goldilocks
// values 3e, 3e+1, 3e+2 (those below k) in its words 0, 1, 2; lane 11 starts
// at `cap` (the leaf tag plus the packed length), every block of 11 packed
// elements is added into lanes 0..10 and permuted, the digest is lane 0.
__global__ void __launch_bounds__(kThreads)
    hash_rows_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t n,
                     int64_t k, int64_t row_stride, int64_t col_stride, Fe cap) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe s[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth - 1; ++j) s[j] = fr::zero();
  s[kWidth - 1] = cap;
  const uint64_t* row = in + i * row_stride;
  const int64_t packed = (k + 2) / 3;
#pragma unroll 1
  for (int64_t b = 0; b < packed; b += kRate) {
#pragma unroll
    for (int j = 0; j < kRate; ++j) {
      const int64_t e = b + j;
      if (e < packed) {
        uint64_t v[3];
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const int64_t col = 3 * e + t;
          v[t] = col < k ? row[col * col_stride] : 0;
        }
        s[j] = fr::add(s[j], fr::to_mont(fr::pack3(v[0], v[1], v[2]), c_fr));
      }
    }
    fr::permute(s, c_fr);
  }
  store_words(out + i * 4, fr::from_mont(s[0]));
}

}  // namespace

// in: n rows of k canonical Goldilocks words, word j of row i at
// in[i·row_stride + j·col_stride]; out: (n, 4) contiguous digests.
extern "C" int ezt_poseidon_fr_hash_rows(const void* in, void* out, long long n, long long k,
                                         long long row_stride, long long col_stride,
                                         const void* cap_words, const void* q_words,
                                         unsigned n0, const void* consts, void* stream) {
  if (int rc = check_modulus(q_words, n0)) return rc;
  if (int rc = upload_consts(consts)) return rc;
  hash_rows_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), n, k, row_stride,
      col_stride, fe_of(cap_words));
  return static_cast<int>(cudaGetLastError());
}
