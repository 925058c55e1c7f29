// Signed radix-2^12 Montgomery arithmetic on one thread's registers, for
// NVIDIA Hopper (sm_90a): the field engine of the radix-12 MSM scan
// (msm_scan_r12.cu, kernel B5). Word for word the torch engine
// icicle_tpu_torch/math/radix12.py and the JAX package's
// icicle_tpu/math/radix12.py, so results are bit-equal to both.
//
// An element is NW int32 words of 12 bits, little-endian and signed:
// value = sum_k w_k 2^(12 k). Adds and subs are wordwise with no carry; a
// multiply accumulates its 2 NW - 1 column sums raw and fuses the REDC into
// them (product scanning, R' = 2^(12 NW)). The caller keeps every operand
// within the bounds the torch side's overflow audit accepts
// (Radix12.audit_mul), so no column sum leaves int32. The one product that
// may, v * inv12 in the REDC, is taken in uint32, whose low 12 bits are
// what the step needs (signed overflow is undefined in C++). A right shift
// of a negative int32 is the arithmetic shift (floor division), as in JAX.

#pragma once

#include <cstdint>

namespace icicle_r12 {

constexpr int kRadix = 12;
constexpr int32_t kMask = (1 << kRadix) - 1;

// The field's constants, passed to a kernel by value.
template <int NW>
struct R12Consts {
  int32_t p[NW];    // p in 12-bit words
  int32_t p2[NW];   // 2p in 12-bit words
  int32_t one[NW];  // R' mod p (1 in Montgomery form)
  uint32_t inv12;   // -p^-1 mod 2^12
  int32_t b3;       // 3b mod p, centred, as a small nonzero integer
};

template <int NW>
struct Words {
  int32_t w[NW];
};

template <int NW>
__device__ __forceinline__ Words<NW> add(const Words<NW>& a, const Words<NW>& b) {
  Words<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = a.w[k] + b.w[k];
  return r;
}

template <int NW>
__device__ __forceinline__ Words<NW> sub(const Words<NW>& a, const Words<NW>& b) {
  Words<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = a.w[k] - b.w[k];
  return r;
}

// Carry-normalise: words in [0, 2^12), a small signed top word.
template <int NW>
__device__ __forceinline__ Words<NW> norm(const Words<NW>& a) {
  Words<NW> r;
  int32_t carry = 0;
#pragma unroll
  for (int k = 0; k < NW - 1; ++k) {
    const int32_t v = a.w[k] + carry;
    r.w[k] = v & kMask;
    carry = v >> kRadix;
  }
  r.w[NW - 1] = a.w[NW - 1] + carry;
  return r;
}

// Normalised value in (-2p, 2p) -> non-negative words, value in [0, 4p):
// norm, then 2p added where the top word is negative.
template <int NW>
__device__ __forceinline__ Words<NW> canon_nonneg(const Words<NW>& x,
                                                  const R12Consts<NW>& c) {
  Words<NW> a = norm<NW>(x);
  const int32_t negm = a.w[NW - 1] >> 31;
#pragma unroll
  for (int k = 0; k < NW; ++k) a.w[k] += c.p2[k] & negm;
  return a;
}

// k x, wordwise; to be normalised before use as a multiply operand.
template <int NW>
__device__ __forceinline__ Words<NW> mul_small(const Words<NW>& x, int32_t k) {
  Words<NW> r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = x.w[i] * k;
  return r;
}

// a * b * R'^-1: columns of the schoolbook product, then per column i
// m = -t_i / p mod 2^12 and m p added into the columns above. Output
// normalised, value in (-p, 2p).
template <int NW>
__device__ __forceinline__ Words<NW> mul_mont(const Words<NW>& a, const Words<NW>& b,
                                              const R12Consts<NW>& c) {
  int32_t cols[2 * NW - 1];
#pragma unroll
  for (int k = 0; k < 2 * NW - 1; ++k) cols[k] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int j = 0; j < NW; ++j) cols[i + j] += a.w[i] * b.w[j];
  }
  int32_t carry = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int32_t v = cols[i] + carry;
    const int32_t m = static_cast<int32_t>((static_cast<uint32_t>(v) * c.inv12) &
                                           static_cast<uint32_t>(kMask));
    carry = (v + m * c.p[0]) >> kRadix;
#pragma unroll
    for (int j = 1; j < NW; ++j) cols[i + j] += m * c.p[j];
  }
  Words<NW> r;
#pragma unroll
  for (int k = NW; k < 2 * NW - 1; ++k) {
    const int32_t v = cols[k] + carry;
    r.w[k - NW] = v & kMask;
    carry = v >> kRadix;
  }
  r.w[NW - 1] = carry;
  return r;
}

// L uint32 limbs (little-endian) -> NW words in [0, 2^12).
template <int NW, int L>
__device__ __forceinline__ Words<NW> from_u32(const uint32_t (&limbs)[L]) {
  Words<NW> r;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const int lo_bit = kRadix * k;
    const int i = lo_bit / 32;
    const int off = lo_bit % 32;
    if (i >= L) {
      r.w[k] = 0;
      continue;
    }
    uint32_t w = limbs[i] >> off;
    if (off > 32 - kRadix && i + 1 < L) w |= limbs[i + 1] << (32 - off);
    r.w[k] = static_cast<int32_t>(w & static_cast<uint32_t>(kMask));
  }
  return r;
}

// Non-negative normalised words -> L uint32 limbs: each word read as
// uint32 and repacked bit field by bit field; bits beyond limb L - 1 drop.
template <int NW, int L>
__device__ __forceinline__ void to_u32(const Words<NW>& a, uint32_t (&limbs)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int lo = 32 * i;
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int wb = kRadix * k;
      if (wb + kRadix <= lo || wb >= lo + 32) continue;
      const uint32_t w = static_cast<uint32_t>(a.w[k]);
      acc |= wb >= lo ? w << (wb - lo) : w >> (lo - wb);
    }
    limbs[i] = acc;
  }
}

// Copies a host array {p[NW], p2[NW], one[NW], inv12, b3} into the struct.
template <int NW>
inline R12Consts<NW> consts_from(const unsigned int* h) {
  R12Consts<NW> c;
  for (int k = 0; k < NW; ++k) {
    c.p[k] = static_cast<int32_t>(h[k]);
    c.p2[k] = static_cast<int32_t>(h[NW + k]);
    c.one[k] = static_cast<int32_t>(h[2 * NW + k]);
  }
  c.inv12 = h[3 * NW];
  c.b3 = static_cast<int32_t>(h[3 * NW + 1]);
  return c;
}

}  // namespace icicle_r12
