// Single-word Montgomery arithmetic of the protocol kernels (fri_fold.cu,
// sumcheck.cu, program.cu) on NVIDIA Hopper (sm_90a). The older kernels
// keep their own (ntt_dif.cu, poseidon2.cuh).
//
// A field is p < 2^31 known at compile time (babybear, koalabear, m31:
// ICICLE_M32_FIELDS); elements are uint32 in [0, p). R = 2^32.
//   add: s = a + b < 2p < 2^32; min(s, s - p) as unsigned (s - p wraps
//     above s when s < p).
//   sub: d = a - b; min(d, d + p) (for a < b, d wraps and d + p is a - b + p).
//   mul: a b R^-1 mod p for a < 2^32, b < p: m = lo(ab) p^-1 mod 2^32, so
//     (ab - m p) / 2^32 = hi(ab) - hi(m p) exactly, in (-p, p); min(r, r + p)
//     as unsigned is r mod p. Three integer multiplies (two wide).
//     With b = c R mod p (c in Montgomery form) it is a c mod p: a canonical
//     value times a Montgomery-form constant stays canonical.
//   halve: x / 2 mod p = x >> 1 for even x, (x + p) >> 1 for odd x.
//   inv: a^(p - 2) in the Montgomery domain by square-and-multiply over the
//     compile-time exponent; 0 gives 0, as the JAX package's inverse does.
// Every result is canonical, so the kernels are bit-equal to their plain
// torch versions (which reduce int64 products with %) whatever the order
// of their adds.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace icicle_m32 {

// p^-1 mod 2^32 for odd p: Newton's iteration from p (right to 3 bits).
constexpr uint32_t inverse32(uint32_t p) {
  uint32_t x = p;
  for (int i = 0; i < 4; ++i) x *= 2u - p * x;
  return x;
}

template <uint32_t P>
struct Mont32 {
  static constexpr uint32_t p = P;
  static constexpr uint32_t pinv = inverse32(P);  // p pinv = 1 mod 2^32
  static constexpr uint32_t one = static_cast<uint32_t>((uint64_t{1} << 32) % P);  // R mod p
  static constexpr uint32_t r2 = static_cast<uint32_t>(uint64_t{one} * one % P);   // R^2 mod p
  static_assert(P < (1u << 31) && (P & 1u) && P * pinv == 1u, "an odd p below 2^31");

  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    const uint32_t s = a + b;
    return min(s, s - P);
  }
  static __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
    const uint32_t d = a - b;
    return min(d, d + P);
  }
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    const uint64_t ab = static_cast<uint64_t>(a) * b;
    const uint32_t m = static_cast<uint32_t>(ab) * pinv;
    const uint32_t r = static_cast<uint32_t>(ab >> 32) -
                       static_cast<uint32_t>((static_cast<uint64_t>(m) * P) >> 32);
    return min(r, r + P);
  }
  static __device__ __forceinline__ uint32_t halve(uint32_t x) {
    return (x + (P & (0u - (x & 1u)))) >> 1;
  }
  static __device__ __forceinline__ uint32_t to_mont(uint32_t a) { return mul(a, r2); }
  static __device__ __forceinline__ uint32_t from_mont(uint32_t a) { return mul(a, 1u); }
  // a^(p - 2) of a Montgomery-form a, in Montgomery form (0 -> 0)
  static __device__ __forceinline__ uint32_t inv(uint32_t a) {
    constexpr uint32_t e = P - 2;
    uint32_t r = one;
#pragma unroll
    for (int bit = 31; bit >= 0; --bit) {
      r = mul(r, r);
      if ((e >> bit) & 1u) r = mul(r, a);
    }
    return r;
  }
};

}  // namespace icicle_m32

// (name, p) of every field the protocol kernels are instantiated for
#define ICICLE_M32_FIELDS(X) \
  X(babybear, 0x78000001u)   \
  X(koalabear, 0x7f000001u)  \
  X(m31, 0x7fffffffu)

// The text of a cudaError_t, for the wrappers' messages; one definition in
// each library that includes this header.
extern "C" const char* icicle_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
