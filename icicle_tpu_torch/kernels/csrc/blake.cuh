// What the BLAKE2s (blake2s.cu) and BLAKE3 (blake3.cu) kernels share on
// NVIDIA Hopper (sm_90a): the G mixing function on one thread's 16 state
// words in registers, and the load of a 16-word message block.
//
// G (RFC 7693 3.1, with BLAKE2s's rotations 16, 12, 8, 7, which BLAKE3
// keeps): a three-input add (IADD3) for a = a + b + m, one XOR and one
// rotation for each d and b update; rotations by 16 and 8 are byte permutes
// (PRMT), by 12 and 7 funnel shifts (SHF): 12 integer instructions a G,
// four of them adds.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace icicle_blake {

__device__ __forceinline__ uint32_t rotr16(uint32_t x) { return __byte_perm(x, 0, 0x1032); }
__device__ __forceinline__ uint32_t rotr8(uint32_t x) { return __byte_perm(x, 0, 0x0321); }
__device__ __forceinline__ uint32_t rotr12(uint32_t x) { return __funnelshift_r(x, x, 12); }
__device__ __forceinline__ uint32_t rotr7(uint32_t x) { return __funnelshift_r(x, x, 7); }

__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c, uint32_t& d,
                                  uint32_t mx, uint32_t my) {
  a = a + b + mx;
  d = rotr16(d ^ a);
  c = c + d;
  b = rotr12(b ^ c);
  a = a + b + my;
  d = rotr8(d ^ a);
  c = c + d;
  b = rotr7(b ^ c);
}

// One round: the four column G's, then the four diagonal G's, over the
// round's message words in schedule order (mr[j] = m[schedule[j]]: the
// caller's selection, register renaming once the rounds are unrolled).
__device__ __forceinline__ void mix_round(uint32_t (&v)[16], const uint32_t (&mr)[16]) {
  g(v[0], v[4], v[8], v[12], mr[0], mr[1]);
  g(v[1], v[5], v[9], v[13], mr[2], mr[3]);
  g(v[2], v[6], v[10], v[14], mr[4], mr[5]);
  g(v[3], v[7], v[11], v[15], mr[6], mr[7]);
  g(v[0], v[5], v[10], v[15], mr[8], mr[9]);
  g(v[1], v[6], v[11], v[12], mr[10], mr[11]);
  g(v[2], v[7], v[8], v[13], mr[12], mr[13]);
  g(v[3], v[4], v[9], v[14], mr[14], mr[15]);
}

// m <- words [first, first + 16) of a row of n words, zero past n. kVec: the
// row starts 16-byte aligned and n is a multiple of 4, so each quarter of
// the block is one 16-byte load (uint4) or wholly past n.
template <bool kVec>
__device__ __forceinline__ void load_block(uint32_t (&m)[16], const uint32_t* row, long long first,
                                           long long n) {
  if constexpr (kVec) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long k = first + 4 * q;
      const uint4 w =
          k < n ? __ldg(reinterpret_cast<const uint4*>(row + k)) : make_uint4(0, 0, 0, 0);
      m[4 * q] = w.x;
      m[4 * q + 1] = w.y;
      m[4 * q + 2] = w.z;
      m[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = first + i < n ? __ldg(row + first + i) : 0u;
  }
}

// The 8 digest words to a 32-byte aligned row: two 16-byte stores.
__device__ __forceinline__ void store8(uint32_t* dst, const uint32_t (&h)[8]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(h[0], h[1], h[2], h[3]);
  d[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

}  // namespace icicle_blake
