// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) on one uint64 a value,
// for NVIDIA Hopper (sm_90a): shared by ntt_wide.cu (dif_rows_wide's Gl64
// instance) and poseidon2.cuh (the Gl64 instances in poseidon2_gl64.cu).
//
// The values are the bits the torch side keeps as an int32 pair [lo, hi]
// (icicle_tpu_torch/math/gl64.py), canonical in [0, p) at every load and
// store. No Montgomery form.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "carry_chain.cuh"

namespace icicle_gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;

// -- lazy representatives ------------------------------------------------------
//
// Between a load and a store a value is any 64-bit word congruent to it mod
// p: no function below subtracts p, and `canonical` does so once, at the
// store (a word is below 2^64 < 2p, so one conditional subtract). Each is
// PTX carry chains over the two 32-bit halves (carry_chain.cuh), a carry out
// of 64 bits folded back as eps = 2^64 mod p by a mad.lo.cc / madc.hi pair
// of the carry bit c and eps (c eps + s, one multiply-add and its carry; a
// mask of the flag added in took 5 instructions a fold and ran the kernel
// 5% slower: PERF.md), a borrow through a mask of the flag (all ones, which
// as a 64-bit word is eps): no compare, no branch.
//   lazy_add: s = a + b; a carry is 2^64 = eps, added back; that add
//     carries again exactly where the first left s >= p, and leaves
//     s + eps - 2^64 = s - p < 2^32 - 1, whose second eps cannot carry.
//   lazy_mul: the 128-bit product r3 2^96 + r2 2^64 + r1 2^32 + r0 from
//     the four 32x32 products in one chain, each product a mad.lo.cc and
//     a madc.hi(.cc) of the same operands next to each other, which ptxas
//     fuses into one IMAD.WIDE.U32 (other orders and four mad.wide.u32
//     with 64-bit addends gave more multiply instructions and a slower
//     kernel: PERF.md); then 2^96 = -1: t = (r1 r0) - r3, a borrow taken
//     back as eps (t >= 2^64 - 2^32 + 1 after one, so no second); then
//     2^64 = eps: t + r2 eps, whose product by eps is a mad.lo.cc /
//     madc.hi.cc pair in the chain, its carry folded back as eps (after a
//     carry t < 2^64 - 2^33 + 1, so no second). Any two 64-bit operands.
//   lazy_sub: d = a - b; a borrow is + 2^64 = + eps, taken back by
//     subtracting eps (the mask of the flag); that borrows again only
//     where d < eps, i.e. b - a > p, and then leaves d - eps + 2^64 >=
//     2^64 - eps, from which the second eps cannot borrow. Any two 64-bit
//     operands.
//   canonical: a - p where a >= p.
// tests/test_torch_gl64_arith.py models each word by word, its carry flag
// one bit, and checks every "carry out: none" below.

constexpr uint32_t EPS32 = 0xFFFFFFFFu;  // eps, one 32-bit word

__device__ __forceinline__ uint32_t lo32(uint64_t a) { return static_cast<uint32_t>(a); }
__device__ __forceinline__ uint32_t hi32(uint64_t a) { return static_cast<uint32_t>(a >> 32); }
__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

__device__ __forceinline__ uint64_t lazy_add(uint64_t a, uint64_t b) {
  using namespace icicle_ptx;
  uint32_t s0 = add_cc(lo32(a), lo32(b));
  uint32_t s1 = addc_cc(hi32(a), hi32(b));
  uint32_t c = addc(0, 0);          // the carry, 2^64 = eps: + c eps
  s0 = mad_lo_cc(c, EPS32, s0);
  s1 = madc_hi_cc(c, EPS32, s1);
  c = addc(0, 0);                   // where that carried again
  s0 = mad_lo_cc(c, EPS32, s0);
  s1 = madc_hi(c, EPS32, s1);       // carry out: none, a second carry left s < 2^32 - 1
  return join(s0, s1);
}

__device__ __forceinline__ uint64_t lazy_mul(uint64_t a, uint64_t b) {
  using namespace icicle_ptx;
  const uint32_t a0 = lo32(a), a1 = hi32(a), b0 = lo32(b), b1 = hi32(b);
  const uint32_t r0 = a0 * b0;
  uint32_t r1 = __umulhi(a0, b0);
  r1 = mad_lo_cc(a0, b1, r1);
  uint32_t r2 = madc_hi_cc(a0, b1, 0);  // its carry out is 0: hi(a0 b1) + 1 < 2^32
  r1 = mad_lo_cc(a1, b0, r1);
  r2 = madc_hi_cc(a1, b0, r2);
  uint32_t r3 = addc(0, 0);
  r2 = mad_lo_cc(a1, b1, r2);
  r3 = madc_hi(a1, b1, r3);          // carry out: none, the product < 2^128
  uint32_t t0 = sub_cc(r0, r3);      // 2^96 = -1
  uint32_t t1 = subc_cc(r1, 0);
  const uint32_t borrow = subc(0, 0);  // eps where t borrowed
  t0 = sub_cc(t0, borrow);
  t1 = subc(t1, 0);                  // carry out: none, t > eps after a borrow
  t0 = mad_lo_cc(r2, EPS32, t0);     // 2^64 = eps: + r2 eps
  t1 = madc_hi_cc(r2, EPS32, t1);
  const uint32_t c = addc(0, 0);     // where that carried: + c eps
  t0 = mad_lo_cc(c, EPS32, t0);
  t1 = madc_hi(c, EPS32, t1);        // carry out: none, t < 2^64 - 2^33 + 1 after a carry
  return join(t0, t1);
}

__device__ __forceinline__ uint64_t lazy_sub(uint64_t a, uint64_t b) {
  using namespace icicle_ptx;
  uint32_t d0 = sub_cc(lo32(a), lo32(b));
  uint32_t d1 = subc_cc(hi32(a), hi32(b));
  uint32_t borrow = subc(0, 0);      // eps where a - b borrowed: - eps
  d0 = sub_cc(d0, borrow);
  d1 = subc_cc(d1, 0);
  borrow = subc(0, 0);               // where that borrowed again
  d0 = sub_cc(d0, borrow);
  d1 = subc(d1, 0);                  // carry out: none, d >= 2^64 - eps after a second borrow
  return join(d0, d1);
}

__device__ __forceinline__ uint64_t canonical(uint64_t a) {
  using namespace icicle_ptx;
  const uint32_t d0 = sub_cc(lo32(a), lo32(P));
  const uint32_t d1 = subc_cc(hi32(a), hi32(P));
  const uint32_t keep = subc(0, 0);  // all ones where a < p
  return join((lo32(a) & keep) | (d0 & ~keep), (hi32(a) & keep) | (d1 & ~keep));
}

}  // namespace icicle_gl
