// Multi-limb Montgomery field arithmetic and complete elliptic-curve adds
// on one thread's registers, for NVIDIA Hopper (sm_90a). Shared by the MSM
// kernels msm_scan.cu (B3), ec_reduce.cu (B4), msm_fold2.cu (B6),
// bucket_accum.cu (B7) and precompute_bases.cu; templated on the limb count
// L. B3, B4 and precompute_bases are instantiated for L = 8 (bn254,
// grumpkin), 12 (bls12_377, bls12_381) and 24 (bw6_761); B6 and B7 for
// L = 8.
//
// Elements are L little-endian uint32 limbs of the canonical value in
// [0, p), Montgomery form with R = 2^(32 L): the bits that the torch side
// keeps as int32 (icicle_tpu_torch/math/bigint.py). Every function returns
// canonical limbs, so results are bit-equal to the torch engine's and the
// JAX package's.
//
// The curve formulas are the complete projective formulas for a = 0
// (Renes-Costello-Batina 2015): Alg 7 (`padd`, 12 Montgomery multiplies + 2
// by b3), Alg 8 (`madd`, 11 + 2) and Alg 9 (`dbl`, 8 + 1), line for line as
// icicle_tpu/curves/group.py. b3 = 3b is a small signed integer on every
// curve built here (9 on bn254, -51 on grumpkin, 3 on bls12_377, 12 on
// bls12_381, -3 on bw6_761), so a multiply by it is a short chain of
// modular adds (`mul_small`), as in the Pallas bodies
// (icicle_tpu/pallas/msm_kernel.py: _ListField.mul_small, _b3_small).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace icicle_ec {

// The curve's constants, passed to a kernel by value (kernel parameters
// live in the constant bank).
template <int L>
struct CurveConsts {
  uint32_t p[L];    // the base-field modulus
  uint32_t one[L];  // 1 in Montgomery form (R mod p)
  uint32_t inv32;   // -p^-1 mod 2^32
  int32_t b3;       // 3b mod p, centred, as a small nonzero integer
};

template <int L>
struct Fp {
  uint32_t v[L];
};

template <int L>
struct Point {  // homogeneous projective; the identity is (0, 1, 0)
  Fp<L> x, y, z;
};

// s + over * 2^(32 L) < 2p -> s mod p.
template <int L>
__device__ __forceinline__ Fp<L> reduce_once(const uint32_t (&s)[L], uint32_t over,
                                             const CurveConsts<L>& c) {
  Fp<L> d;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t t = static_cast<uint64_t>(s[j]) - c.p[j] - borrow;
    d.v[j] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  const bool use_d = over != 0 || borrow == 0;
  Fp<L> r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = use_d ? d.v[j] : s[j];
  return r;
}

template <int L>
__device__ __forceinline__ Fp<L> add_mod(const Fp<L>& a, const Fp<L>& b,
                                         const CurveConsts<L>& c) {
  uint32_t s[L];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t t = static_cast<uint64_t>(a.v[j]) + b.v[j] + carry;
    s[j] = static_cast<uint32_t>(t);
    carry = static_cast<uint32_t>(t >> 32);
  }
  return reduce_once<L>(s, carry, c);
}

template <int L>
__device__ __forceinline__ Fp<L> sub_mod(const Fp<L>& a, const Fp<L>& b,
                                         const CurveConsts<L>& c) {
  uint32_t d[L];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t t = static_cast<uint64_t>(a.v[j]) - b.v[j] - borrow;
    d[j] = static_cast<uint32_t>(t);
    borrow = static_cast<uint32_t>(t >> 63);
  }
  const uint32_t mask = 0u - borrow;  // add p back when a < b
  Fp<L> r;
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint64_t t = static_cast<uint64_t>(d[j]) + (c.p[j] & mask) + carry;
    r.v[j] = static_cast<uint32_t>(t);
    carry = static_cast<uint32_t>(t >> 32);
  }
  return r;
}

// a * b * R^-1 mod p: CIOS with 32-bit words. Each 32x32->64 product is one
// mad.wide.u32; a*b_i + t_j + carry < 2^64, so no step overflows. The outer
// loop is unrolled up to L = 12; at L = 24 it stays rolled (each of the
// curve formulas' multiplies would otherwise be 1,200 straight-line
// multiply-adds, and the compile time with them).
template <int L>
__device__ __forceinline__ Fp<L> mont_mul(const Fp<L>& a, const Fp<L>& b,
                                          const CurveConsts<L>& c) {
  uint32_t t[L + 2];
#pragma unroll
  for (int j = 0; j < L + 2; ++j) t[j] = 0;
#pragma unroll (L <= 12 ? L : 1)
  for (int i = 0; i < L; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint64_t s = static_cast<uint64_t>(a.v[j]) * b.v[i] + t[j] + carry;
      t[j] = static_cast<uint32_t>(s);
      carry = s >> 32;
    }
    uint64_t s = static_cast<uint64_t>(t[L]) + carry;
    t[L] = static_cast<uint32_t>(s);
    t[L + 1] = static_cast<uint32_t>(s >> 32);
    const uint32_t m = t[0] * c.inv32;  // cancels word 0
    s = static_cast<uint64_t>(m) * c.p[0] + t[0];
    carry = s >> 32;
#pragma unroll
    for (int j = 1; j < L; ++j) {
      s = static_cast<uint64_t>(m) * c.p[j] + t[j] + carry;
      t[j - 1] = static_cast<uint32_t>(s);
      carry = s >> 32;
    }
    s = static_cast<uint64_t>(t[L]) + carry;
    t[L - 1] = static_cast<uint32_t>(s);
    t[L] = t[L + 1] + static_cast<uint32_t>(s >> 32);
  }
  uint32_t lo[L];
#pragma unroll
  for (int j = 0; j < L; ++j) lo[j] = t[j];
  return reduce_once<L>(lo, t[L], c);  // t < 2p
}

// k x mod p for a small nonzero integer k: double-and-add from k's top bit,
// then a negation when k < 0. Canonical, so equal to a Montgomery multiply
// by k's Montgomery form.
template <int L>
__device__ __forceinline__ Fp<L> mul_small(const Fp<L>& x, int32_t k,
                                           const CurveConsts<L>& c) {
  const uint32_t a = k < 0 ? 0u - static_cast<uint32_t>(k) : static_cast<uint32_t>(k);
  Fp<L> acc = x;
#pragma unroll 1
  for (int bit = 30 - __clz(static_cast<int>(a)); bit >= 0; --bit) {
    acc = add_mod<L>(acc, acc, c);
    if ((a >> bit) & 1u) acc = add_mod<L>(acc, x, c);
  }
  if (k < 0) {
    Fp<L> zero;
#pragma unroll
    for (int j = 0; j < L; ++j) zero.v[j] = 0;
    acc = sub_mod<L>(zero, acc, c);
  }
  return acc;
}

template <int L>
__device__ __forceinline__ Point<L> identity(const CurveConsts<L>& c) {
  Point<L> e;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    e.x.v[j] = 0;
    e.y.v[j] = c.one[j];
    e.z.v[j] = 0;
  }
  return e;
}

// Complete mixed add, RCB15 Alg 8 (a = 0): p + (x2, y2, 1). (x2, y2) must
// be a curve point (affine cannot encode the identity).
template <int L>
__device__ __forceinline__ Point<L> madd(const Point<L>& p, const Fp<L>& x2,
                                         const Fp<L>& y2, const CurveConsts<L>& c) {
  Fp<L> t0 = mont_mul<L>(p.x, x2, c);
  Fp<L> t1 = mont_mul<L>(p.y, y2, c);
  const Fp<L> t3 = sub_mod<L>(
      mont_mul<L>(add_mod<L>(p.x, p.y, c), add_mod<L>(x2, y2, c), c),
      add_mod<L>(t0, t1, c), c);                                  // x1y2 + x2y1
  const Fp<L> t4 = add_mod<L>(mont_mul<L>(y2, p.z, c), p.y, c);   // y1 + y2z1
  Fp<L> y3 = add_mod<L>(mont_mul<L>(x2, p.z, c), p.x, c);         // x1 + x2z1
  t0 = add_mod<L>(add_mod<L>(t0, t0, c), t0, c);                  // 3 x1x2
  const Fp<L> t2 = mul_small<L>(p.z, c.b3, c);                   // 3b z1
  Fp<L> z3 = add_mod<L>(t1, t2, c);
  t1 = sub_mod<L>(t1, t2, c);
  y3 = mul_small<L>(y3, c.b3, c);
  Point<L> r;
  r.x = sub_mod<L>(mont_mul<L>(t3, t1, c), mont_mul<L>(t4, y3, c), c);
  r.y = add_mod<L>(mont_mul<L>(t1, z3, c), mont_mul<L>(y3, t0, c), c);
  r.z = add_mod<L>(mont_mul<L>(z3, t4, c), mont_mul<L>(t0, t3, c), c);
  return r;
}

// Complete projective add, RCB15 Alg 7 (a = 0): p + q.
template <int L>
__device__ __forceinline__ Point<L> padd(const Point<L>& p, const Point<L>& q,
                                         const CurveConsts<L>& c) {
  Fp<L> t0 = mont_mul<L>(p.x, q.x, c);
  Fp<L> t1 = mont_mul<L>(p.y, q.y, c);
  Fp<L> t2 = mont_mul<L>(p.z, q.z, c);
  const Fp<L> t3 = sub_mod<L>(
      mont_mul<L>(add_mod<L>(p.x, p.y, c), add_mod<L>(q.x, q.y, c), c),
      add_mod<L>(t0, t1, c), c);                                  // x1y2 + x2y1
  const Fp<L> t4 = sub_mod<L>(
      mont_mul<L>(add_mod<L>(p.y, p.z, c), add_mod<L>(q.y, q.z, c), c),
      add_mod<L>(t1, t2, c), c);                                  // y1z2 + y2z1
  Fp<L> y3 = sub_mod<L>(
      mont_mul<L>(add_mod<L>(p.x, p.z, c), add_mod<L>(q.x, q.z, c), c),
      add_mod<L>(t0, t2, c), c);                                  // x1z2 + x2z1
  t0 = add_mod<L>(add_mod<L>(t0, t0, c), t0, c);                  // 3 x1x2
  t2 = mul_small<L>(t2, c.b3, c);                                 // 3b z1z2
  Fp<L> z3 = add_mod<L>(t1, t2, c);
  t1 = sub_mod<L>(t1, t2, c);
  y3 = mul_small<L>(y3, c.b3, c);                                 // 3b (x1z2 + x2z1)
  Point<L> r;
  r.x = sub_mod<L>(mont_mul<L>(t3, t1, c), mont_mul<L>(t4, y3, c), c);
  r.y = add_mod<L>(mont_mul<L>(t1, z3, c), mont_mul<L>(y3, t0, c), c);
  r.z = add_mod<L>(mont_mul<L>(z3, t4, c), mont_mul<L>(t0, t3, c), c);
  return r;
}

// Complete doubling, RCB15 Alg 9 (a = 0): 2p, as icicle_tpu/curves/group.py
// pdbl.
template <int L>
__device__ __forceinline__ Point<L> dbl(const Point<L>& p, const CurveConsts<L>& c) {
  Fp<L> t0 = mont_mul<L>(p.y, p.y, c);
  Fp<L> z3 = add_mod<L>(t0, t0, c);
  z3 = add_mod<L>(z3, z3, c);
  z3 = add_mod<L>(z3, z3, c);                                     // 8 y^2
  Fp<L> t1 = mont_mul<L>(p.y, p.z, c);
  Fp<L> t2 = mul_small<L>(mont_mul<L>(p.z, p.z, c), c.b3, c);     // 3b z^2
  Fp<L> x3 = mont_mul<L>(t2, z3, c);
  Fp<L> y3 = add_mod<L>(t0, t2, c);
  z3 = mont_mul<L>(t1, z3, c);
  t1 = add_mod<L>(t2, t2, c);
  t2 = add_mod<L>(t1, t2, c);                                     // 9b z^2
  t0 = sub_mod<L>(t0, t2, c);                                     // y^2 - 9b z^2
  y3 = add_mod<L>(mont_mul<L>(t0, y3, c), x3, c);
  x3 = mont_mul<L>(t0, mont_mul<L>(p.x, p.y, c), c);
  Point<L> r;
  r.x = add_mod<L>(x3, x3, c);
  r.y = y3;
  r.z = z3;
  return r;
}

// Copies a host array {p[L], one[L], inv32, b3} into the struct (b3 as
// its two's-complement bits).
template <int L>
inline CurveConsts<L> consts_from(const unsigned int* h) {
  CurveConsts<L> c;
  for (int j = 0; j < L; ++j) {
    c.p[j] = h[j];
    c.one[j] = h[L + j];
  }
  c.inv32 = h[2 * L];
  c.b3 = static_cast<int32_t>(h[2 * L + 1]);
  return c;
}

// Points in the MSM kernels' lane-minor layout: limb j of a coordinate at
// src[j * row], x / y / z in rows 0..L-1 / L..2L-1 / 2L..3L-1, so a warp's
// neighbouring lanes read and write neighbouring words.
template <int L>
__device__ __forceinline__ Fp<L> load_fp(const uint32_t* src, size_t row) {
  Fp<L> a;
#pragma unroll
  for (int j = 0; j < L; ++j) a.v[j] = src[j * row];
  return a;
}

template <int L>
__device__ __forceinline__ Point<L> load_point(const uint32_t* src, size_t row) {
  Point<L> p;
  p.x = load_fp<L>(src, row);
  p.y = load_fp<L>(src + L * row, row);
  p.z = load_fp<L>(src + 2 * L * row, row);
  return p;
}

template <int L>
__device__ __forceinline__ void store_point(uint32_t* dst, size_t row, const Point<L>& p) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    dst[j * row] = p.x.v[j];
    dst[(L + j) * row] = p.y.v[j];
    dst[(2 * L + j) * row] = p.z.v[j];
  }
}

// Threads per block of the kernels that keep one thread per lane over the
// whole serial axis (B6 msm_fold2.cu, B7 bucket_accum.cu): at their lane
// counts (8192; 12 x 1024) 32-thread blocks spread the lanes over all SMs.
constexpr int kLaneThreads = 32;

// Threads per block of the kernels that split the serial axis over many
// threads (B3 msm_scan.cu, B4 ec_reduce.cu). Their __launch_bounds__ asks
// for one block per SM: ptxas may then take up to 255 registers and takes
// about 150-200, keeping more of each multiply chain in flight, so one
// block (8 warps) fits an SM. That ran faster than ptxas's default choice
// (about 110-150) and than a minimum of two blocks (16 warps, a
// 128-register cap, where it spilled).
constexpr int kSplitThreads = 256;

}  // namespace icicle_ec

// Each library that includes this header is one source file, and exports
// the text of its launches' error codes.
extern "C" const char* icicle_msm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
