// Multi-limb Montgomery field arithmetic, its quadratic extension, and
// complete elliptic-curve adds on one thread's registers, for NVIDIA Hopper
// (sm_90a). Shared by the MSM kernels msm_scan.cu (B3), ec_reduce.cu (B4),
// msm_fold2.cu (B6), bucket_accum.cu (B7) and precompute_bases.cu;
// templated on the limb count L and, for the curve formulas, on the
// coordinate field. G1 points (and bw6_761's G2, which lies over Fq) take
// Fp<L>: B3, B4, B6, B7 and precompute_bases are instantiated for L = 8
// (bn254, grumpkin), 12 (bls12_377, bls12_381) and 24 (bw6_761). G2
// points over Fp2 = Fp[u]/(u^2 - nr) take Fp2<L>: B3, B4 and
// precompute_bases at L = 8 (bn254) and 12 (bls12_377, bls12_381).
//
// Elements are L little-endian uint32 limbs of the canonical value in
// [0, p), Montgomery form with R = 2^(32 L): the bits that the torch side
// keeps as int32 (icicle_tpu_torch/math/bigint.py). An Fp2 element is two
// of them, c0 then c1 (c0 + c1 u), as icicle_tpu_torch/fields/extension.py
// lays them out flat. Every function returns canonical limbs, so results
// are bit-equal to the torch engine's and the JAX package's whatever the
// route (an Fp2 product here is Karatsuba's three multiplies, the torch
// engine's its schoolbook four).
//
// The curve formulas are the complete projective formulas for a = 0
// (Renes-Costello-Batina 2015): Alg 7 (`padd`, 12 multiplies + 2 by b3),
// Alg 8 (`madd`, 11 + 2) and Alg 9 (`dbl`, 8 + 1), line for line as
// icicle_tpu/curves/group.py. Over Fp, b3 = 3b is a small signed integer on
// every curve built here (9 on bn254, -51 on grumpkin, 3 on bls12_377, 12
// on bls12_381, -3 on bw6_761, 12 on bw6_761's G2), so a multiply by it is
// a short chain of modular adds (`mul_small`), as in the Pallas bodies
// (icicle_tpu/pallas/msm_kernel.py: _ListField.mul_small, _b3_small). Over
// Fp2, b3 is a general constant in the kernel's consts (bn254's G2: both
// parts 254 bits; bls12_377's: (0, a full element)), except where it is
// k + k u with a small k (bls12_381's G2: 12 + 12 u), which takes add
// chains again.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace icicle_ec {

// The curve's constants, passed to a kernel by value (kernel parameters
// live in the constant bank).
template <int L>
struct CurveConsts {
  static constexpr int kBaseLimbs = L;
  uint32_t p[L];    // the base-field modulus
  uint32_t one[L];  // 1 in Montgomery form (R mod p)
  uint32_t inv32;   // -p^-1 mod 2^32
  int32_t b3;       // 3b mod p, centred, as a small nonzero integer
};

template <int L>
struct Fp {
  static constexpr int kWords = L;
  uint32_t v[L];
  __device__ __forceinline__ uint32_t& w(int j) { return v[j]; }
  __device__ __forceinline__ const uint32_t& w(int j) const { return v[j]; }
};

// c0 + c1 u over Fp<L>, u^2 = nr: 2L words, c0's limbs first.
template <int L>
struct Fp2 {
  static constexpr int kWords = 2 * L;
  Fp<L> c0, c1;
  __device__ __forceinline__ uint32_t& w(int j) { return j < L ? c0.v[j] : c1.v[j - L]; }
  __device__ __forceinline__ const uint32_t& w(int j) const {
    return j < L ? c0.v[j] : c1.v[j - L];
  }
};

// An Fp2 coordinate field's constants: its base field's (f.b3 is k where
// b3 = k + k u with a small k, else 0), the non-residue and b3 in
// Montgomery form.
template <int L>
struct Fp2Consts {
  static constexpr int kBaseLimbs = L;
  CurveConsts<L> f;
  int32_t nr;   // u^2 = nr, a small negative integer (-1 or -5)
  Fp2<L> b3;
};

// The coordinate field that a consts type serves.
template <class C>
struct CoordOf;
template <int L>
struct CoordOf<CurveConsts<L>> {
  using type = Fp<L>;
};
template <int L>
struct CoordOf<Fp2Consts<L>> {
  using type = Fp2<L>;
};
template <class C>
using Coord = typename CoordOf<C>::type;

template <class F>
struct ECPoint {  // homogeneous projective; the identity is (0, 1, 0)
  F x, y, z;
};

template <int L>
using Point = ECPoint<Fp<L>>;

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

// The field operations the curve formulas take, over Fp<L> (CurveConsts)
// and over Fp2<L> (Fp2Consts); overloads picked by the consts' type.
template <int L>
__device__ __forceinline__ Fp<L> f_add(const Fp<L>& a, const Fp<L>& b, const CurveConsts<L>& c) {
  return add_mod<L>(a, b, c);
}

template <int L>
__device__ __forceinline__ Fp<L> f_sub(const Fp<L>& a, const Fp<L>& b, const CurveConsts<L>& c) {
  return sub_mod<L>(a, b, c);
}

template <int L>
__device__ __forceinline__ Fp<L> f_mul(const Fp<L>& a, const Fp<L>& b, const CurveConsts<L>& c) {
  return mont_mul<L>(a, b, c);
}

template <int L>
__device__ __forceinline__ Fp<L> f_mul_b3(const Fp<L>& x, const CurveConsts<L>& c) {
  return mul_small<L>(x, c.b3, c);
}

template <int L>
__device__ __forceinline__ Fp<L> f_zero(const CurveConsts<L>&) {
  Fp<L> a;
#pragma unroll
  for (int j = 0; j < L; ++j) a.v[j] = 0;
  return a;
}

template <int L>
__device__ __forceinline__ Fp<L> f_one(const CurveConsts<L>& c) {  // Montgomery form
  Fp<L> a;
#pragma unroll
  for (int j = 0; j < L; ++j) a.v[j] = c.one[j];
  return a;
}

template <int L>
__device__ __forceinline__ Fp2<L> f_add(const Fp2<L>& a, const Fp2<L>& b, const Fp2Consts<L>& c) {
  return {add_mod<L>(a.c0, b.c0, c.f), add_mod<L>(a.c1, b.c1, c.f)};
}

template <int L>
__device__ __forceinline__ Fp2<L> f_sub(const Fp2<L>& a, const Fp2<L>& b, const Fp2Consts<L>& c) {
  return {sub_mod<L>(a.c0, b.c0, c.f), sub_mod<L>(a.c1, b.c1, c.f)};
}

// Karatsuba: v0 = a0 b0, v1 = a1 b1, c0 = v0 + nr v1 (nr < 0: v0 - |nr|
// v1 by an add chain), c1 = (a0 + a1)(b0 + b1) - v0 - v1. Three Montgomery
// multiplies.
template <int L>
__device__ __forceinline__ Fp2<L> f_mul(const Fp2<L>& a, const Fp2<L>& b, const Fp2Consts<L>& c) {
  const Fp<L> v0 = mont_mul<L>(a.c0, b.c0, c.f);
  const Fp<L> v1 = mont_mul<L>(a.c1, b.c1, c.f);
  const Fp<L> t = mont_mul<L>(add_mod<L>(a.c0, a.c1, c.f), add_mod<L>(b.c0, b.c1, c.f), c.f);
  return {sub_mod<L>(v0, mul_small<L>(v1, -c.nr, c.f), c.f),
          sub_mod<L>(t, add_mod<L>(v0, v1, c.f), c.f)};
}

// x b3: where b3 = k + k u, (k (x0 + nr x1), k (x0 + x1)) by add chains;
// else a multiply by the constant.
template <int L>
__device__ __forceinline__ Fp2<L> f_mul_b3(const Fp2<L>& x, const Fp2Consts<L>& c) {
  if (c.f.b3 != 0) {
    const Fp<L> u = sub_mod<L>(x.c0, mul_small<L>(x.c1, -c.nr, c.f), c.f);
    return {mul_small<L>(u, c.f.b3, c.f), mul_small<L>(add_mod<L>(x.c0, x.c1, c.f), c.f.b3, c.f)};
  }
  return f_mul<L>(x, c.b3, c);
}

template <int L>
__device__ __forceinline__ Fp2<L> f_zero(const Fp2Consts<L>& c) {
  return {f_zero<L>(c.f), f_zero<L>(c.f)};
}

template <int L>
__device__ __forceinline__ Fp2<L> f_one(const Fp2Consts<L>& c) {
  return {f_one<L>(c.f), f_zero<L>(c.f)};
}

template <class C>
__device__ __forceinline__ ECPoint<Coord<C>> identity(const C& c) {
  return {f_zero(c), f_one(c), f_zero(c)};
}

// Complete mixed add, RCB15 Alg 8 (a = 0): p + (x2, y2, 1). (x2, y2) must
// be a curve point (affine cannot encode the identity).
template <class C>
__device__ __forceinline__ ECPoint<Coord<C>> madd(const ECPoint<Coord<C>>& p,
                                                  const Coord<C>& x2, const Coord<C>& y2,
                                                  const C& c) {
  using F = Coord<C>;
  F t0 = f_mul(p.x, x2, c);
  F t1 = f_mul(p.y, y2, c);
  const F t3 = f_sub(f_mul(f_add(p.x, p.y, c), f_add(x2, y2, c), c),
                     f_add(t0, t1, c), c);                        // x1y2 + x2y1
  const F t4 = f_add(f_mul(y2, p.z, c), p.y, c);                  // y1 + y2z1
  F y3 = f_add(f_mul(x2, p.z, c), p.x, c);                        // x1 + x2z1
  t0 = f_add(f_add(t0, t0, c), t0, c);                            // 3 x1x2
  const F t2 = f_mul_b3(p.z, c);                                  // 3b z1
  F z3 = f_add(t1, t2, c);
  t1 = f_sub(t1, t2, c);
  y3 = f_mul_b3(y3, c);
  ECPoint<F> r;
  r.x = f_sub(f_mul(t3, t1, c), f_mul(t4, y3, c), c);
  r.y = f_add(f_mul(t1, z3, c), f_mul(y3, t0, c), c);
  r.z = f_add(f_mul(z3, t4, c), f_mul(t0, t3, c), c);
  return r;
}

// Complete projective add, RCB15 Alg 7 (a = 0): p + q.
template <class C>
__device__ __forceinline__ ECPoint<Coord<C>> padd(const ECPoint<Coord<C>>& p,
                                                  const ECPoint<Coord<C>>& q, const C& c) {
  using F = Coord<C>;
  F t0 = f_mul(p.x, q.x, c);
  F t1 = f_mul(p.y, q.y, c);
  F t2 = f_mul(p.z, q.z, c);
  const F t3 = f_sub(f_mul(f_add(p.x, p.y, c), f_add(q.x, q.y, c), c),
                     f_add(t0, t1, c), c);                        // x1y2 + x2y1
  const F t4 = f_sub(f_mul(f_add(p.y, p.z, c), f_add(q.y, q.z, c), c),
                     f_add(t1, t2, c), c);                        // y1z2 + y2z1
  F y3 = f_sub(f_mul(f_add(p.x, p.z, c), f_add(q.x, q.z, c), c),
               f_add(t0, t2, c), c);                              // x1z2 + x2z1
  t0 = f_add(f_add(t0, t0, c), t0, c);                            // 3 x1x2
  t2 = f_mul_b3(t2, c);                                           // 3b z1z2
  F z3 = f_add(t1, t2, c);
  t1 = f_sub(t1, t2, c);
  y3 = f_mul_b3(y3, c);                                           // 3b (x1z2 + x2z1)
  ECPoint<F> r;
  r.x = f_sub(f_mul(t3, t1, c), f_mul(t4, y3, c), c);
  r.y = f_add(f_mul(t1, z3, c), f_mul(y3, t0, c), c);
  r.z = f_add(f_mul(z3, t4, c), f_mul(t0, t3, c), c);
  return r;
}

// Complete doubling, RCB15 Alg 9 (a = 0): 2p, as icicle_tpu/curves/group.py
// pdbl.
template <class C>
__device__ __forceinline__ ECPoint<Coord<C>> dbl(const ECPoint<Coord<C>>& p, const C& c) {
  using F = Coord<C>;
  F t0 = f_mul(p.y, p.y, c);
  F z3 = f_add(t0, t0, c);
  z3 = f_add(z3, z3, c);
  z3 = f_add(z3, z3, c);                                          // 8 y^2
  F t1 = f_mul(p.y, p.z, c);
  F t2 = f_mul_b3(f_mul(p.z, p.z, c), c);                         // 3b z^2
  F x3 = f_mul(t2, z3, c);
  F y3 = f_add(t0, t2, c);
  z3 = f_mul(t1, z3, c);
  t1 = f_add(t2, t2, c);
  t2 = f_add(t1, t2, c);                                          // 9b z^2
  t0 = f_sub(t0, t2, c);                                          // y^2 - 9b z^2
  y3 = f_add(f_mul(t0, y3, c), x3, c);
  x3 = f_mul(t0, f_mul(p.x, p.y, c), c);
  ECPoint<F> r;
  r.x = f_add(x3, x3, c);
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

// Copies a host array {p[L], one[L], inv32, k, nr, b3.c0[L], b3.c1[L]}
// (k, nr as two's-complement bits; k is 0 unless b3 = k + k u) into the
// struct.
template <int L>
inline Fp2Consts<L> fp2_consts_from(const unsigned int* h) {
  Fp2Consts<L> c;
  c.f = consts_from<L>(h);
  c.nr = static_cast<int32_t>(h[2 * L + 2]);
  for (int j = 0; j < L; ++j) {
    c.b3.c0.v[j] = h[2 * L + 3 + j];
    c.b3.c1.v[j] = h[3 * L + 3 + j];
  }
  return c;
}

// A consts type's host array, read by the overload of its type; and its
// length in words.
template <int L>
inline void read_consts(const unsigned int* h, CurveConsts<L>& c) {
  c = consts_from<L>(h);
}

template <int L>
inline void read_consts(const unsigned int* h, Fp2Consts<L>& c) {
  c = fp2_consts_from<L>(h);
}

template <class C>
struct ConstsWords;
template <int L>
struct ConstsWords<CurveConsts<L>> {
  static constexpr int value = 2 * L + 2;
};
template <int L>
struct ConstsWords<Fp2Consts<L>> {
  static constexpr int value = 4 * L + 3;
};

// Points in the MSM kernels' lane-minor layout: word j of a coordinate at
// src[j * row], x / y / z in rows 0..W-1 / W..2W-1 / 2W..3W-1 for a
// coordinate of W words (L for Fp<L>, 2L for Fp2<L>), so a warp's
// neighbouring lanes read and write neighbouring words.
template <class F>
__device__ __forceinline__ F load_coord(const uint32_t* src, size_t row) {
  F a;
#pragma unroll
  for (int j = 0; j < F::kWords; ++j) a.w(j) = src[j * row];
  return a;
}

template <class F>
__device__ __forceinline__ ECPoint<F> load_pt(const uint32_t* src, size_t row) {
  constexpr int W = F::kWords;
  return {load_coord<F>(src, row), load_coord<F>(src + W * row, row),
          load_coord<F>(src + 2 * W * row, row)};
}

template <class F>
__device__ __forceinline__ void store_pt(uint32_t* dst, size_t row, const ECPoint<F>& p) {
  constexpr int W = F::kWords;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    dst[j * row] = p.x.w(j);
    dst[(W + j) * row] = p.y.w(j);
    dst[(2 * W + j) * row] = p.z.w(j);
  }
}

// The Fp<L> forms the single-field kernels (B6, B7) call.
template <int L>
__device__ __forceinline__ Fp<L> load_fp(const uint32_t* src, size_t row) {
  return load_coord<Fp<L>>(src, row);
}

template <int L>
__device__ __forceinline__ Point<L> load_point(const uint32_t* src, size_t row) {
  return load_pt<Fp<L>>(src, row);
}

template <int L>
__device__ __forceinline__ void store_point(uint32_t* dst, size_t row, const Point<L>& p) {
  store_pt<Fp<L>>(dst, row, p);
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
