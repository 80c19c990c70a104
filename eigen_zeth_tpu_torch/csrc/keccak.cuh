// Keccak-f[1600] and the keccak256 sponge (rate 136 bytes, Ethereum's
// padding 0x01 ... 0x80) for kernel G, one state per thread.
//
// The 25 lanes are 64-bit words in registers; every index and rotation
// below is a literal (theta, rho and pi, chi and iota written out lane by
// lane), so nothing of the state is addressed at run time and the compiler
// keeps it out of local memory.  A rotation by a constant is two funnel
// shifts of 32-bit halves on the card.  The round constants live in the
// constant bank, read uniformly by a warp.
//
// The header also compiles with a host C++ compiler, so the permutation
// that the kernel runs can be held to the python reference on a machine
// without a GPU (tests/test_torch_keccak.py).

#pragma once

#include <cstdint>

#if !defined(__CUDACC__)
#define __device__
#define __forceinline__ inline
#define __constant__
#endif

namespace ezt {
namespace keccak {

typedef unsigned long long u64;

constexpr int kRounds = 24;
constexpr int kRateLanes = 17;  // 136 bytes
constexpr int kDigestLanes = 4;  // 32 bytes

__constant__ const u64 kRoundConstants[kRounds] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

__device__ __forceinline__ u64 rotl(u64 x, int r) { return (x << r) | (x >> (64 - r)); }

// One round on a[25] (index x + 5·y), round constant rc.
__device__ __forceinline__ void keccak_round(u64* a, u64 rc) {
  // theta
  const u64 c0 = a[0] ^ a[5] ^ a[10] ^ a[15] ^ a[20];
  const u64 c1 = a[1] ^ a[6] ^ a[11] ^ a[16] ^ a[21];
  const u64 c2 = a[2] ^ a[7] ^ a[12] ^ a[17] ^ a[22];
  const u64 c3 = a[3] ^ a[8] ^ a[13] ^ a[18] ^ a[23];
  const u64 c4 = a[4] ^ a[9] ^ a[14] ^ a[19] ^ a[24];
  const u64 d0 = c4 ^ rotl(c1, 1);
  const u64 d1 = c0 ^ rotl(c2, 1);
  const u64 d2 = c1 ^ rotl(c3, 1);
  const u64 d3 = c2 ^ rotl(c4, 1);
  const u64 d4 = c3 ^ rotl(c0, 1);
  a[0] ^= d0;
  a[1] ^= d1;
  a[2] ^= d2;
  a[3] ^= d3;
  a[4] ^= d4;
  a[5] ^= d0;
  a[6] ^= d1;
  a[7] ^= d2;
  a[8] ^= d3;
  a[9] ^= d4;
  a[10] ^= d0;
  a[11] ^= d1;
  a[12] ^= d2;
  a[13] ^= d3;
  a[14] ^= d4;
  a[15] ^= d0;
  a[16] ^= d1;
  a[17] ^= d2;
  a[18] ^= d3;
  a[19] ^= d4;
  a[20] ^= d0;
  a[21] ^= d1;
  a[22] ^= d2;
  a[23] ^= d3;
  a[24] ^= d4;
  // rho and pi: b[pi(i)] = rotl(a[i], rho(i))
  const u64 b0 = a[0];
  const u64 b1 = rotl(a[6], 44);
  const u64 b2 = rotl(a[12], 43);
  const u64 b3 = rotl(a[18], 21);
  const u64 b4 = rotl(a[24], 14);
  const u64 b5 = rotl(a[3], 28);
  const u64 b6 = rotl(a[9], 20);
  const u64 b7 = rotl(a[10], 3);
  const u64 b8 = rotl(a[16], 45);
  const u64 b9 = rotl(a[22], 61);
  const u64 b10 = rotl(a[1], 1);
  const u64 b11 = rotl(a[7], 6);
  const u64 b12 = rotl(a[13], 25);
  const u64 b13 = rotl(a[19], 8);
  const u64 b14 = rotl(a[20], 18);
  const u64 b15 = rotl(a[4], 27);
  const u64 b16 = rotl(a[5], 36);
  const u64 b17 = rotl(a[11], 10);
  const u64 b18 = rotl(a[17], 15);
  const u64 b19 = rotl(a[23], 56);
  const u64 b20 = rotl(a[2], 62);
  const u64 b21 = rotl(a[8], 55);
  const u64 b22 = rotl(a[14], 39);
  const u64 b23 = rotl(a[15], 41);
  const u64 b24 = rotl(a[21], 2);
  // chi
  a[0] = b0 ^ (~b1 & b2);
  a[1] = b1 ^ (~b2 & b3);
  a[2] = b2 ^ (~b3 & b4);
  a[3] = b3 ^ (~b4 & b0);
  a[4] = b4 ^ (~b0 & b1);
  a[5] = b5 ^ (~b6 & b7);
  a[6] = b6 ^ (~b7 & b8);
  a[7] = b7 ^ (~b8 & b9);
  a[8] = b8 ^ (~b9 & b5);
  a[9] = b9 ^ (~b5 & b6);
  a[10] = b10 ^ (~b11 & b12);
  a[11] = b11 ^ (~b12 & b13);
  a[12] = b12 ^ (~b13 & b14);
  a[13] = b13 ^ (~b14 & b10);
  a[14] = b14 ^ (~b10 & b11);
  a[15] = b15 ^ (~b16 & b17);
  a[16] = b16 ^ (~b17 & b18);
  a[17] = b17 ^ (~b18 & b19);
  a[18] = b18 ^ (~b19 & b15);
  a[19] = b19 ^ (~b15 & b16);
  a[20] = b20 ^ (~b21 & b22);
  a[21] = b21 ^ (~b22 & b23);
  a[22] = b22 ^ (~b23 & b24);
  a[23] = b23 ^ (~b24 & b20);
  a[24] = b24 ^ (~b20 & b21);
  // iota
  a[0] ^= rc;
}

__device__ __forceinline__ void permute(u64* a) {
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) keccak_round(a, kRoundConstants[r]);
}

}  // namespace keccak
}  // namespace ezt
