// Field arithmetic and curve formulas for the prefix scan's and the EC
// reduce's wide instances (msm_scan.cu, B3, and ec_reduce.cu, B4, at 12 or
// more words a coordinate: Fp<12> for bls12_377 / bls12_381 G1, Fp<24> for
// bw6_761 G1 and G2, Fp2<8> for bn254 G2, Fp2<12> for bls12_377 /
// bls12_381 G2), for NVIDIA Hopper (sm_90a). Those two sources include it
// only where ICICLE_EC_LIMBS * ICICLE_EC_DEGREE >= 12; their 8-limb G1
// instances (bn254, grumpkin) and the other MSM kernels keep ec_field.cuh's
// arithmetic (the padd of ec_reduce.cu's row loop and tree: `padd_row`
// below). precompute_bases.cu
// (every instance; the Jacobian doubling `jdbl` and the squaring `fsqr`
// below are its), poseidon_limbs.cu (the 8-limb Poseidon) and ecntt.cu
// (the ECNTT's stage and ladder at 8, 12 and 24 limbs; the projective
// doubling `pdbl` below is its) include it too.
//
// What differs from ec_field.cuh, and why:
// - The Montgomery multiply is PTX carry chains (mad.lo.cc / madc.hi.cc:
//   a 32x32 product is its two multiplies and no separate add), its
//   products split into two independent chains, the even limbs of a (and
//   p) into an accumulator at word offset 0 and the odd limbs into one at
//   offset 1, merged once at the end; so a thread has two chains in
//   flight. ec_field.cuh's CIOS writes each product as a 64-bit multiply
//   plus 64-bit adds, one serial chain of about 2 L^2 steps.
// - Lazy reduction: every value between two stores lies in [0, 2p), not
//   [0, p). That holds because 4p < R = 2^(32 L) on every curve built here
//   (the launch refuses a modulus without two spare bits): a product of
//   two values below 2p is below 4p^2 / R + p < 2p with no final
//   subtraction; a sum is reduced by 2p, a difference brought back by 2p.
//   Every value stored to `out` or `carries` is made canonical
//   (`store_canonical`), so the stored bits are the plain version's.
// - The madd is ordered so that few values are live at once (eight
//   coordinates at most beside the multiply in flight, by the order of its
//   lines): the slot's x is loaded just before its first use and y after
//   the x products, and each input dies at its last use.
// Bit-exactness: the formulas are RCB15 Alg 8, Alg 7 and Alg 9 line for
// line (ec_field.cuh madd / padd / dbl), so every coordinate is the same element of
// the field as the plain version's; canonical limbs of the same element
// are the same bits.
//
// A PTX carry flag lives from one instruction of a chain to the next
// (carry_chain.cuh's primitives, one `asm volatile` statement each). Where
// a chain ends without taking its carry out (an instruction without .cc),
// the comment "carry out: none" says why there is none;
// tests/test_torch_msm_wide_arith.py models every chain word by word with
// a one-bit flag and checks each of those places.
//
// The 24-limb multiply keeps its outer loop rolled (two words of b an
// iteration, b from a local copy): unrolled, each of a madd's eleven
// multiplies would be about 2,400 straight-line instructions.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "carry_chain.cuh"
#include "ec_field.cuh"

namespace icicle_ec {
namespace wide {

using namespace icicle_ptx;  // the PTX primitives: add_cc, madc_hi, ...

// -- constants ---------------------------------------------------------------

// A base field's constants as the wide arithmetic takes them.
template <int L>
struct BaseConsts {
  uint32_t p[L];    // the modulus, with 4p < 2^(32 L)
  uint32_t p2[L];   // 2p
  uint32_t one[L];  // R mod p
  uint32_t inv32;   // -p^-1 mod 2^32
  int32_t k;        // over Fp: b3; over Fp2: k where b3 = k + k u, else 0
};

// The coordinate field's constants (F: its element type), built on the
// host from ec_field.cuh's CurveConsts / Fp2Consts (`wide_consts`): the
// consts type that the overloads below are picked by.
template <int L>
struct WideFp {
  using F = Fp<L>;
  BaseConsts<L> f;
};

template <int L>
struct WideFp2 {
  using F = Fp2<L>;
  BaseConsts<L> f;
  int32_t nr;  // u^2 = nr, a small negative integer
  Fp2<L> b3;   // Montgomery form, canonical
};

template <int L>
inline BaseConsts<L> base_consts(const CurveConsts<L>& c) {
  BaseConsts<L> f;
  uint64_t carry = 0;
  for (int j = 0; j < L; ++j) {
    f.p[j] = c.p[j];
    f.one[j] = c.one[j];
    const uint64_t t = 2ull * c.p[j] + carry;
    f.p2[j] = static_cast<uint32_t>(t);
    carry = t >> 32;
  }
  f.inv32 = c.inv32;
  f.k = c.b3;
  return f;
}

template <int L>
inline WideFp<L> wide_consts(const CurveConsts<L>& c) {
  return {base_consts<L>(c)};
}

template <int L>
inline WideFp2<L> wide_consts(const icicle_ec::Fp2Consts<L>& c) {
  WideFp2<L> w;
  w.f = base_consts<L>(c.f);
  w.nr = c.nr;
  w.b3 = c.b3;
  return w;
}

// 4p < 2^(32 L): the modulus's top two bits are clear.
template <int L>
inline bool lazy_ok(const BaseConsts<L>& f) {
  return (f.p[L - 1] >> 30) == 0;
}

// -- Fp<L>, values in [0, 2p) ------------------------------------------------

// a + b mod p in [0, 2p): s = a + b < 4p, then s - 2p where that is >= 0.
template <int L>
__device__ __forceinline__ Fp<L> add(const Fp<L>& a, const Fp<L>& b, const BaseConsts<L>& f) {
  uint32_t s[L], d[L];
  s[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < L - 1; ++j) s[j] = addc_cc(a.v[j], b.v[j]);
  s[L - 1] = addc(a.v[L - 1], b.v[L - 1]);  // carry out: none, s < 4p < 2^(32 L)
  d[0] = sub_cc(s[0], f.p2[0]);
#pragma unroll
  for (int j = 1; j < L; ++j) d[j] = subc_cc(s[j], f.p2[j]);
  const uint32_t keep = subc(0, 0);  // all ones where s < 2p
  Fp<L> r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = (s[j] & keep) | (d[j] & ~keep);
  return r;
}

// a - b mod p in [0, 2p): d = a - b, plus 2p where that borrowed.
template <int L>
__device__ __forceinline__ Fp<L> sub(const Fp<L>& a, const Fp<L>& b, const BaseConsts<L>& f) {
  uint32_t d[L];
  d[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int j = 1; j < L; ++j) d[j] = subc_cc(a.v[j], b.v[j]);
  const uint32_t back = subc(0, 0);  // all ones where a < b
  Fp<L> r;
  r.v[0] = add_cc(d[0], f.p2[0] & back);
#pragma unroll
  for (int j = 1; j < L - 1; ++j) r.v[j] = addc_cc(d[j], f.p2[j] & back);
  // carry out: none kept, it is 1 exactly where a < b and cancels the borrow
  r.v[L - 1] = addc(d[L - 1], f.p2[L - 1] & back);
  return r;
}

// [0, 2p) -> [0, p)
template <int L>
__device__ __forceinline__ Fp<L> canonical(const Fp<L>& a, const BaseConsts<L>& f) {
  uint32_t d[L];
  d[0] = sub_cc(a.v[0], f.p[0]);
#pragma unroll
  for (int j = 1; j < L; ++j) d[j] = subc_cc(a.v[j], f.p[j]);
  const uint32_t keep = subc(0, 0);  // all ones where a < p
  Fp<L> r;
#pragma unroll
  for (int j = 0; j < L; ++j) r.v[j] = (a.v[j] & keep) | (d[j] & ~keep);
  return r;
}

// One word of the multiply: the accumulators acc (word offset 0) and odd
// (offset 1) take a * bi, then mi p with mi = acc[0] (-p^-1) mod 2^32,
// which zeroes acc[0]. The next word shifts the sum down a word by
// swapping the roles: the old odd becomes acc, acc[1] is added to its
// word 0, and acc[2..] becomes the new odd, all in the chains below.
// While a < 2p and every step's sum stays below 2^32 (a + p) < 2^(32 (L +
// 1)), odd never passes L words, so its chains end without a carry.
template <bool kFirst, int L>
__device__ __forceinline__ void mul_step(uint32_t (&acc)[L], uint32_t (&odd)[L], const Fp<L>& a,
                                         uint32_t bi, const BaseConsts<L>& f) {
  if (kFirst) {
#pragma unroll
    for (int j = 0; j < L; j += 2) {
      acc[j] = a.v[j] * bi;
      acc[j + 1] = __umulhi(a.v[j], bi);
      odd[j] = a.v[j + 1] * bi;
      odd[j + 1] = __umulhi(a.v[j + 1], bi);
    }
  } else {
    acc[0] = add_cc(acc[0], odd[1]);
#pragma unroll
    for (int j = 0; j < L - 2; j += 2) {
      odd[j] = madc_lo_cc(a.v[j + 1], bi, odd[j + 2]);
      odd[j + 1] = madc_hi_cc(a.v[j + 1], bi, odd[j + 3]);
    }
    odd[L - 2] = madc_lo_cc(a.v[L - 1], bi, 0);
    odd[L - 1] = madc_hi(a.v[L - 1], bi, 0);  // carry out: none, odd < 2^(32 L)
    acc[0] = mad_lo_cc(a.v[0], bi, acc[0]);
    acc[1] = madc_hi_cc(a.v[0], bi, acc[1]);
#pragma unroll
    for (int j = 2; j < L; j += 2) {
      acc[j] = madc_lo_cc(a.v[j], bi, acc[j]);
      acc[j + 1] = madc_hi_cc(a.v[j], bi, acc[j + 1]);
    }
    odd[L - 1] = addc(odd[L - 1], 0);  // carry out: none, odd < 2^(32 L)
  }
  const uint32_t mi = acc[0] * f.inv32;
  odd[0] = mad_lo_cc(f.p[1], mi, odd[0]);
  odd[1] = madc_hi_cc(f.p[1], mi, odd[1]);
#pragma unroll
  for (int j = 2; j < L - 2; j += 2) {
    odd[j] = madc_lo_cc(f.p[j + 1], mi, odd[j]);
    odd[j + 1] = madc_hi_cc(f.p[j + 1], mi, odd[j + 1]);
  }
  odd[L - 2] = madc_lo_cc(f.p[L - 1], mi, odd[L - 2]);
  odd[L - 1] = madc_hi(f.p[L - 1], mi, odd[L - 1]);  // carry out: none, odd < 2^(32 L)
  acc[0] = mad_lo_cc(f.p[0], mi, acc[0]);
  acc[1] = madc_hi_cc(f.p[0], mi, acc[1]);
#pragma unroll
  for (int j = 2; j < L; j += 2) {
    acc[j] = madc_lo_cc(f.p[j], mi, acc[j]);
    acc[j + 1] = madc_hi_cc(f.p[j], mi, acc[j + 1]);
  }
  odd[L - 1] = addc(odd[L - 1], 0);  // carry out: none, odd < 2^(32 L)
}

// a b R^-1 mod p in [0, 2p) for a, b in [0, 2p). L even. Words of b two
// at a time (one step into each accumulator role); at L > 12 that loop
// stays rolled over a local copy of b.
template <int L>
__device__ __forceinline__ Fp<L> mul(const Fp<L>& a, const Fp<L>& b, const BaseConsts<L>& f) {
  static_assert(L % 2 == 0, "the even/odd chains take an even limb count");
  uint32_t e[L], o[L];
  mul_step<true, L>(e, o, a, b.v[0], f);
  mul_step<false, L>(o, e, a, b.v[1], f);
  if constexpr (L <= 12) {
#pragma unroll
    for (int i = 2; i < L; i += 2) {
      mul_step<false, L>(e, o, a, b.v[i], f);
      mul_step<false, L>(o, e, a, b.v[i + 1], f);
    }
  } else {
    uint32_t bw[L];
#pragma unroll
    for (int j = 0; j < L; ++j) bw[j] = b.v[j];
#pragma unroll 1
    for (int i = 2; i < L; i += 2) {
      mul_step<false, L>(e, o, a, bw[i], f);
      mul_step<false, L>(o, e, a, bw[i + 1], f);
    }
  }
  // the last step left acc = o (word 0 zero) and odd = e: the result is
  // the sum shifted down a word, o[1..] + e
  Fp<L> r;
  r.v[0] = add_cc(e[0], o[1]);
#pragma unroll
  for (int j = 1; j < L - 1; ++j) r.v[j] = addc_cc(e[j], o[j + 1]);
  r.v[L - 1] = addc(e[L - 1], 0);  // carry out: none, the result < 2p
  return r;
}

// x s mod p for a small nonzero integer s: double-and-add from s's top
// bit, then a negation where s < 0.
template <int L>
__device__ __forceinline__ Fp<L> mul_small(const Fp<L>& x, int32_t s, const BaseConsts<L>& f) {
  const uint32_t a = s < 0 ? 0u - static_cast<uint32_t>(s) : static_cast<uint32_t>(s);
  Fp<L> acc = x;
#pragma unroll 1
  for (int bit = 30 - __clz(static_cast<int>(a)); bit >= 0; --bit) {
    acc = add<L>(acc, acc, f);
    if ((a >> bit) & 1u) acc = add<L>(acc, x, f);
  }
  if (s < 0) {
    Fp<L> zero;
#pragma unroll
    for (int j = 0; j < L; ++j) zero.v[j] = 0;
    acc = sub<L>(zero, acc, f);
  }
  return acc;
}

// -- the coordinate field: overloads on the consts type ----------------------

template <int L>
__device__ __forceinline__ Fp<L> fadd(const Fp<L>& a, const Fp<L>& b, const WideFp<L>& k) {
  return add<L>(a, b, k.f);
}

template <int L>
__device__ __forceinline__ Fp<L> fsub(const Fp<L>& a, const Fp<L>& b, const WideFp<L>& k) {
  return sub<L>(a, b, k.f);
}

template <int L>
__device__ __forceinline__ Fp<L> fmul(const Fp<L>& a, const Fp<L>& b, const WideFp<L>& k) {
  return mul<L>(a, b, k.f);
}

template <int L>
__device__ __forceinline__ Fp<L> fmul_b3(const Fp<L>& x, const WideFp<L>& k) {
  return mul_small<L>(x, k.f.k, k.f);
}

template <int L>
__device__ __forceinline__ Fp<L> fcanonical(const Fp<L>& a, const WideFp<L>& k) {
  return canonical<L>(a, k.f);
}

template <int L>
__device__ __forceinline__ Fp<L> fone(const WideFp<L>& k) {
  Fp<L> a;
#pragma unroll
  for (int j = 0; j < L; ++j) a.v[j] = k.f.one[j];
  return a;
}

template <int L>
__device__ __forceinline__ Fp<L> fzero(const WideFp<L>&) {
  Fp<L> a;
#pragma unroll
  for (int j = 0; j < L; ++j) a.v[j] = 0;
  return a;
}

template <int L>
__device__ __forceinline__ Fp2<L> fadd(const Fp2<L>& a, const Fp2<L>& b, const WideFp2<L>& k) {
  return {add<L>(a.c0, b.c0, k.f), add<L>(a.c1, b.c1, k.f)};
}

template <int L>
__device__ __forceinline__ Fp2<L> fsub(const Fp2<L>& a, const Fp2<L>& b, const WideFp2<L>& k) {
  return {sub<L>(a.c0, b.c0, k.f), sub<L>(a.c1, b.c1, k.f)};
}

// Karatsuba, the sums' product first (while a and b are still whole):
// t = (a0 + a1)(b0 + b1), v0 = a0 b0, v1 = a1 b1, c0 = v0 + nr v1 (nr < 0:
// v0 - |nr| v1 by an add chain), c1 = t - v0 - v1.
template <int L>
__device__ __forceinline__ Fp2<L> fmul(const Fp2<L>& a, const Fp2<L>& b, const WideFp2<L>& k) {
  const Fp<L> t = mul<L>(add<L>(a.c0, a.c1, k.f), add<L>(b.c0, b.c1, k.f), k.f);
  const Fp<L> v0 = mul<L>(a.c0, b.c0, k.f);
  const Fp<L> v1 = mul<L>(a.c1, b.c1, k.f);
  return {sub<L>(v0, mul_small<L>(v1, -k.nr, k.f), k.f), sub<L>(t, add<L>(v0, v1, k.f), k.f)};
}

// x b3: where b3 = k + k u, (k (x0 + nr x1), k (x0 + x1)) by add chains;
// else a multiply by the constant.
template <int L>
__device__ __forceinline__ Fp2<L> fmul_b3(const Fp2<L>& x, const WideFp2<L>& k) {
  if (k.f.k != 0) {
    const Fp<L> u = sub<L>(x.c0, mul_small<L>(x.c1, -k.nr, k.f), k.f);
    return {mul_small<L>(u, k.f.k, k.f), mul_small<L>(add<L>(x.c0, x.c1, k.f), k.f.k, k.f)};
  }
  return fmul<L>(x, k.b3, k);
}

template <int L>
__device__ __forceinline__ Fp2<L> fcanonical(const Fp2<L>& a, const WideFp2<L>& k) {
  return {canonical<L>(a.c0, k.f), canonical<L>(a.c1, k.f)};
}

template <int L>
__device__ __forceinline__ Fp2<L> fone(const WideFp2<L>& k) {
  Fp2<L> a;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    a.c0.v[j] = k.f.one[j];
    a.c1.v[j] = 0;
  }
  return a;
}

template <int L>
__device__ __forceinline__ Fp2<L> fzero(const WideFp2<L>&) {
  Fp2<L> a;
#pragma unroll
  for (int j = 0; j < L; ++j) a.c0.v[j] = a.c1.v[j] = 0;
  return a;
}

// -- points --------------------------------------------------------------------

template <class K>
__device__ __forceinline__ ECPoint<typename K::F> identity(const K& k) {
  return {fzero(k), fone(k), fzero(k)};
}

// Stores p's canonical coordinates in the lane-minor layout (ec_field.cuh
// store_pt).
template <class K>
__device__ __forceinline__ void store_canonical(uint32_t* dst, size_t row,
                                                const ECPoint<typename K::F>& p, const K& k) {
  store_pt<typename K::F>(dst, row, {fcanonical(p.x, k), fcanonical(p.y, k), fcanonical(p.z, k)});
}

// p + (x2, y2, 1), RCB15 Alg 8 (a = 0), with (x2, y2) the slot's affine
// point at src (x in words src[j row], y in the W rows after them), which
// must be a curve point. The same lines as ec_field.cuh madd, reordered:
// X1 + Y1 before X1's last use, x2 loaded just before X1 x2, y2 after
// x2's products, x2 + y2 as soon as both are there.
template <class K>
__device__ __forceinline__ ECPoint<typename K::F> madd_slot(const ECPoint<typename K::F>& p,
                                                            const uint32_t* __restrict__ src,
                                                            size_t row, const K& k) {
  using F = typename K::F;
  constexpr int W = F::kWords;
  const F sp = fadd(p.x, p.y, k);                       // x1 + y1
  const F x2 = load_coord<F>(src, row);
  F t0 = fmul(p.x, x2, k);                              // x1 x2
  F y3 = fadd(fmul(x2, p.z, k), p.x, k);                // x1 + x2 z1
  const F y2 = load_coord<F>(src + W * row, row);
  const F s2 = fadd(x2, y2, k);                         // x2 + y2
  F t1 = fmul(p.y, y2, k);                              // y1 y2
  const F t4 = fadd(fmul(y2, p.z, k), p.y, k);          // y1 + y2 z1
  const F t3 = fsub(fmul(sp, s2, k), fadd(t0, t1, k), k);  // x1 y2 + x2 y1
  const F t2 = fmul_b3(p.z, k);                         // 3b z1
  t0 = fadd(fadd(t0, t0, k), t0, k);                    // 3 x1 x2
  const F z3 = fadd(t1, t2, k);
  t1 = fsub(t1, t2, k);
  y3 = fmul_b3(y3, k);
  ECPoint<F> r;
  r.x = fsub(fmul(t3, t1, k), fmul(t4, y3, k), k);
  r.y = fadd(fmul(t1, z3, k), fmul(y3, t0, k), k);
  r.z = fadd(fmul(z3, t4, k), fmul(t0, t3, k), k);
  return r;
}

// p + q, RCB15 Alg 7 (a = 0), the same lines as ec_field.cuh padd, in
// their order: the carry scan runs S - 1 of them a lane, against the
// folds' 2 K (S - 1) / S madds (where it is the inner loop, ec_reduce.cu,
// padd_row below loads q a coordinate at a time).
template <class K>
__device__ __forceinline__ ECPoint<typename K::F> padd(const ECPoint<typename K::F>& p,
                                                       const ECPoint<typename K::F>& q,
                                                       const K& k) {
  using F = typename K::F;
  F t0 = fmul(p.x, q.x, k);
  F t1 = fmul(p.y, q.y, k);
  F t2 = fmul(p.z, q.z, k);
  const F t3 = fsub(fmul(fadd(p.x, p.y, k), fadd(q.x, q.y, k), k), fadd(t0, t1, k), k);
  const F t4 = fsub(fmul(fadd(p.y, p.z, k), fadd(q.y, q.z, k), k), fadd(t1, t2, k), k);
  F y3 = fsub(fmul(fadd(p.x, p.z, k), fadd(q.x, q.z, k), k), fadd(t0, t2, k), k);
  t0 = fadd(fadd(t0, t0, k), t0, k);
  t2 = fmul_b3(t2, k);
  const F z3 = fadd(t1, t2, k);
  t1 = fsub(t1, t2, k);
  y3 = fmul_b3(y3, k);
  ECPoint<F> r;
  r.x = fsub(fmul(t3, t1, k), fmul(t4, y3, k), k);
  r.y = fadd(fmul(t1, z3, k), fmul(y3, t0, k), k);
  r.z = fadd(fmul(z3, t4, k), fmul(t0, t3, k), k);
  return r;
}

// p + (x2, y2, z2), RCB15 Alg 7 (a = 0), with the second point's
// coordinates at src (x in words src[j row], y and z in the W rows after
// each other): ec_reduce.cu's row loop and tree, where it is the inner
// loop. The same lines as padd, ordered for registers as madd_slot: each
// of x2, y2, z2 is loaded just before its first product and dies at its
// last sum, and each of x1, y1, z1 dies at its last use, so at most nine
// coordinates are live beside the multiply in flight.
template <class K>
__device__ __forceinline__ ECPoint<typename K::F> padd_row(const ECPoint<typename K::F>& p,
                                                           const uint32_t* __restrict__ src,
                                                           size_t row, const K& k) {
  using F = typename K::F;
  constexpr int W = F::kWords;
  const F x2 = load_coord<F>(src, row);
  F t0 = fmul(p.x, x2, k);                              // x1 x2
  const F sxy = fadd(p.x, p.y, k);                      // x1 + y1
  const F sxz = fadd(p.x, p.z, k);                      // x1 + z1
  const F y2 = load_coord<F>(src + W * row, row);
  F t1 = fmul(p.y, y2, k);                              // y1 y2
  const F syz = fadd(p.y, p.z, k);                      // y1 + z1
  const F t3 = fsub(fmul(sxy, fadd(x2, y2, k), k), fadd(t0, t1, k), k);
  const F z2 = load_coord<F>(src + 2 * W * row, row);
  F t2 = fmul(p.z, z2, k);                              // z1 z2
  const F t4 = fsub(fmul(syz, fadd(y2, z2, k), k), fadd(t1, t2, k), k);
  F y3 = fsub(fmul(sxz, fadd(x2, z2, k), k), fadd(t0, t2, k), k);
  t0 = fadd(fadd(t0, t0, k), t0, k);
  t2 = fmul_b3(t2, k);
  const F z3 = fadd(t1, t2, k);
  t1 = fsub(t1, t2, k);
  y3 = fmul_b3(y3, k);
  ECPoint<F> r;
  r.x = fsub(fmul(t3, t1, k), fmul(t4, y3, k), k);
  r.y = fadd(fmul(t1, z3, k), fmul(y3, t0, k), k);
  r.z = fadd(fmul(z3, t4, k), fmul(t0, t3, k), k);
  return r;
}

// 2 p, RCB15 Alg 9 (a = 0), the same lines as ec_field.cuh dbl, in their
// order (ecntt.cu's ladders): 8 products and one by b3.
template <class K>
__device__ __forceinline__ ECPoint<typename K::F> pdbl(const ECPoint<typename K::F>& p,
                                                       const K& k) {
  using F = typename K::F;
  F t0 = fmul(p.y, p.y, k);
  F z3 = fadd(t0, t0, k);
  z3 = fadd(z3, z3, k);
  z3 = fadd(z3, z3, k);                                 // 8 y^2
  F t1 = fmul(p.y, p.z, k);
  F t2 = fmul_b3(fmul(p.z, p.z, k), k);                 // 3b z^2
  F x3 = fmul(t2, z3, k);
  F y3 = fadd(t0, t2, k);
  z3 = fmul(t1, z3, k);
  t1 = fadd(t2, t2, k);
  t2 = fadd(t1, t2, k);                                 // 9b z^2
  t0 = fsub(t0, t2, k);                                 // y^2 - 9b z^2
  y3 = fadd(fmul(t0, y3, k), x3, k);
  x3 = fmul(t0, fmul(p.x, p.y, k), k);
  ECPoint<F> r;
  r.x = fadd(x3, x3, k);
  r.y = y3;
  r.z = z3;
  return r;
}

// -- the Jacobian doubling (precompute_bases.cu) ---------------------------------

// a^2: over Fp the multiply itself (no dedicated squaring).
template <int L>
__device__ __forceinline__ Fp<L> fsqr(const Fp<L>& a, const WideFp<L>& k) {
  return mul<L>(a, a, k.f);
}

// a^2 over Fp2, the complex squaring (2 base products): v = a0 a1,
// c0 = (a0 + a1)(a0 + nr a1) - (1 + nr) v, c1 = 2 v; (1 + nr) v by an add
// chain, none where nr = -1.
template <int L>
__device__ __forceinline__ Fp2<L> fsqr(const Fp2<L>& a, const WideFp2<L>& k) {
  const Fp<L> v = mul<L>(a.c0, a.c1, k.f);
  const Fp<L> t = mul<L>(add<L>(a.c0, a.c1, k.f),
                         sub<L>(a.c0, mul_small<L>(a.c1, -k.nr, k.f), k.f), k.f);
  const Fp<L> c0 = k.nr == -1 ? t : sub<L>(t, mul_small<L>(v, 1 + k.nr, k.f), k.f);
  return {c0, add<L>(v, v, k.f)};
}

// 2 p for p = (X, Y, Z) in Jacobian coordinates (x = X / Z^2, y = Y / Z^3;
// Z = 0 the identity, which it keeps), dbl-2009-l at a = 0 (2M + 5S):
// A = X^2, B = Y^2, C = B^2, D = 2 ((X + B)^2 - A - C), E = 3 A, F = E^2,
// X3 = F - 2 D, Y3 = E (D - X3) - 8 C, Z3 = 2 Y Z. b does not enter.
template <class K>
__device__ __forceinline__ ECPoint<typename K::F> jdbl(const ECPoint<typename K::F>& p,
                                                       const K& k) {
  using F = typename K::F;
  F z3 = fmul(p.y, p.z, k);
  z3 = fadd(z3, z3, k);
  const F a = fsqr(p.x, k);
  const F b = fsqr(p.y, k);
  F d = fsqr(fadd(p.x, b, k), k);
  const F c = fsqr(b, k);
  d = fsub(fsub(d, a, k), c, k);
  d = fadd(d, d, k);
  const F e = fadd(fadd(a, a, k), a, k);
  const F x3 = fsub(fsqr(e, k), fadd(d, d, k), k);
  F c8 = fadd(c, c, k);
  c8 = fadd(c8, c8, k);
  c8 = fadd(c8, c8, k);
  return {x3, fsub(fmul(e, fsub(d, x3, k), k), c8, k), z3};
}

// Threads a block of the wide instances' folding passes, and the blocks
// an SM their launch bounds ask for: two blocks of 128 keep ptxas's cap at
// 255 registers (no spill at 12 limbs or over Fp2<8>) with the 8 warps an
// SM of one block of 256, and spread a small grid over more SMs (E3's
// K 512 x C 1024 scans ran 5-23% faster on an NVIDIA H100 80GB HBM3 at
// 700 W; kernels/msm_scan_probe.py, PERF.md). Two blocks of 256 cap it at
// 128 registers, and spilled.
constexpr int kWideSplitThreads = 128;
constexpr int kWideBlocksPerSM = 2;

}  // namespace wide
}  // namespace icicle_ec
