// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on one uint64 a value,
// for NVIDIA Hopper (sm_90a): shared by ntt_wide.cu (dif_rows_wide) and
// poseidon2.cuh (the Gl64 instances in poseidon2_gl64.cu).
//
// The values are the bits the torch side keeps as an int32 pair [lo, hi]
// (icicle_tpu_torch/math/gl64.py), canonical in [0, p). No Montgomery
// form. Every function returns a canonical value, so results are bit-equal
// to the torch engine's and the JAX package's.
//   add: a carry out of 64 bits is 2^64 = eps = 2^32 - 1 (mod p), and
//     a + b - 2^64 + eps < p, so adding eps ends the carry; then one
//     conditional subtract of p. The field has no slack bit: a sum of two
//     canonical values can carry.
//   sub: a - b, plus p on a borrow.
//   mul: the 128-bit product (a 64-bit multiply and __umul64hi),
//     n3 2^96 + n2 2^64 + lo, reduced by 2^96 = -1 and 2^64 = eps step for
//     step as icicle_tpu/math/gl64.py `_reduce128`: t = lo - n3 (a borrow
//     takes eps back), t + n2 eps (a carry adds eps), one conditional
//     subtract. It reduces any two 64-bit operands.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace icicle_gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;  // carried 2^64 = eps; s + eps < p, no second carry
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d + P : d;  // a borrow wrapped by 2^64: add p back
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t n2 = hi & 0xFFFFFFFFull, n3 = hi >> 32;
  uint64_t t = lo - n3;                // 2^96 = -1
  if (lo < n3) t -= EPS;               // the borrow added 2^64 = eps; t >= eps here
  const uint64_t e = (n2 << 32) - n2;  // n2 eps = n2 2^64 mod p, below 2^64
  uint64_t r = t + e;
  if (r < t) r += EPS;                 // carried 2^64 = eps; cannot carry again
  return r >= P ? r - P : r;
}

}  // namespace icicle_gl
