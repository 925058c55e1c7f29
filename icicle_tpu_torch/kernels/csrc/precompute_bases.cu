// Precomputed MSM bases (msm_precompute_bases) on NVIDIA Hopper (sm_90a).
// Bound to Python with ctypes (icicle_tpu_torch/kernels/precompute_kernel.py:
// precompute_bases).
//
// Replaces no Pallas kernel: the JAX package computes this in XLA,
//   icicle_tpu/ops/msm.py:313  msm_precompute_bases.chunk_fn,
// and the kernel computes the same function: for each canonical affine
// point P_i ((0, 0) is the identity) and each copy j < nu,
// out[nu i + j] = 2^(j shift) P_i in canonical affine coordinates, (0, 0)
// for the identity.
//   px, py  (n, W) uint32 canonical coordinates, a point a row, W words a
//           coordinate (L over Fp; 2L over Fp2 for G2, c0 then c1);
//   ox, oy  (nu n, W) uint32, interleaved: row nu i + j is copy j of P_i;
//           copy 0 is the input as given.
// A canonical affine point is unique, so the output equals the plain
// version's (precompute_bases_ref: the port's Group.dbl chain and
// to_affine_canonical) bit for bit whatever the doubling formula; the
// kernel uses the same one (ec_field.cuh dbl, RCB15 Alg 9).
//
// Bound: operations. Per point 2 Montgomery multiplies into Montgomery
// form; per copy j >= 1, `shift` doublings of 8 Montgomery multiplies (the
// one by b3 is an add chain), a Fermat inversion of z (bits(p - 2)
// squarings and popcount(p - 2) multiplies, as BigField.pow_const) and 4
// multiplies (x z^-1, y z^-1, both out of Montgomery form); each Montgomery
// multiply 4L^2 + L 32-bit multiplies. Bytes: n 2L words read, nu n 2L
// written (chip_smoke.py computes both from each run's shapes).
//
// Design: one thread a point. A copy's doublings depend on the last, so a
// point's work is serial and the points are the lanes. Each copy is
// inverted on its own; Montgomery's batch inversion (one inversion for a
// thread's nu - 1 copies, or across threads) is later work. A thread reads
// and writes its rows with the row's stride (a point's L words are
// contiguous): the bytes are a small part of the time. Instantiated for
// L = 8, 12 and 24 over Fp, and for L = 8 and 12 over Fp2 (G2 of bn254,
// bls12_377, bls12_381), where a copy's inversion goes through the norm,
// z0^2 - nr z1^2, in Fp; the C entry dispatches on L.

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

namespace {

using namespace icicle_ec;

// one thread a point; small blocks spread a few thousand points over the SMs
constexpr int kPrecomputeThreads = 64;

// A point's coordinate at row i of a (rows, W) array, its W words contiguous.
template <class F>
__device__ __forceinline__ F load_row(const uint32_t* src, size_t i) {
  F a;
#pragma unroll
  for (int j = 0; j < F::kWords; ++j) a.w(j) = src[i * F::kWords + j];
  return a;
}

template <class F>
__device__ __forceinline__ void store_row(uint32_t* dst, size_t i, const F& a) {
#pragma unroll
  for (int j = 0; j < F::kWords; ++j) dst[i * F::kWords + j] = a.w(j);
}

// The field steps of the kernel over Fp (CurveConsts) and Fp2 (Fp2Consts);
// r2: R^2 mod p; e: p - 2 with ebits bits (the Fermat exponent).
template <int L>
__device__ __forceinline__ Fp<L> to_mont(const Fp<L>& a, const Fp<L>& r2,
                                         const CurveConsts<L>& c) {
  return mont_mul<L>(a, r2, c);
}

template <int L>
__device__ __forceinline__ Fp2<L> to_mont(const Fp2<L>& a, const Fp<L>& r2,
                                          const Fp2Consts<L>& c) {
  return {mont_mul<L>(a.c0, r2, c.f), mont_mul<L>(a.c1, r2, c.f)};
}

template <int L>
__device__ __forceinline__ Fp<L> from_mont(const Fp<L>& a, const CurveConsts<L>& c) {
  Fp<L> unit = f_zero<L>(c);  // 1, canonical: a Montgomery multiply by it leaves the form
  unit.v[0] = 1;
  return mont_mul<L>(a, unit, c);
}

template <int L>
__device__ __forceinline__ Fp2<L> from_mont(const Fp2<L>& a, const Fp2Consts<L>& c) {
  return {from_mont<L>(a.c0, c.f), from_mont<L>(a.c1, c.f)};
}

// z^(p-2) in Montgomery form, left to right from 1 (0 -> 0).
template <int L>
__device__ __forceinline__ Fp<L> inv_mont(const Fp<L>& z, const Fp<L>& e, int ebits,
                                          const CurveConsts<L>& c) {
  Fp<L> zi = f_one<L>(c);
#pragma unroll 1
  for (int b = ebits - 1; b >= 0; --b) {
    zi = mont_mul<L>(zi, zi, c);
    if ((e.v[b >> 5] >> (b & 31)) & 1u) zi = mont_mul<L>(zi, z, c);
  }
  return zi;
}

// Through the norm: (z0 - z1 u) / (z0^2 - nr z1^2), one inversion in Fp.
template <int L>
__device__ __forceinline__ Fp2<L> inv_mont(const Fp2<L>& z, const Fp<L>& e, int ebits,
                                           const Fp2Consts<L>& c) {
  const Fp<L> norm = add_mod<L>(mont_mul<L>(z.c0, z.c0, c.f),
                                mul_small<L>(mont_mul<L>(z.c1, z.c1, c.f), -c.nr, c.f), c.f);
  const Fp<L> ni = inv_mont<L>(norm, e, ebits, c.f);
  return {mont_mul<L>(z.c0, ni, c.f), sub_mod<L>(f_zero<L>(c.f), mont_mul<L>(z.c1, ni, c.f), c.f)};
}

template <class C>
__global__ void __launch_bounds__(kPrecomputeThreads)
precompute_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                  uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, int n, int nu,
                  int shift, const C c, const Fp<C::kBaseLimbs> r2,
                  const Fp<C::kBaseLimbs> e, int ebits) {
  using F = Coord<C>;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const F x = load_row<F>(px, i);
  const F y = load_row<F>(py, i);
  const size_t first = static_cast<size_t>(nu) * i;
  store_row<F>(ox, first, x);
  store_row<F>(oy, first, y);
  bool inf = true;
#pragma unroll
  for (int j = 0; j < F::kWords; ++j) inf = inf && x.w(j) == 0 && y.w(j) == 0;
  ECPoint<F> cur = identity(c);
  if (!inf) {
    cur.x = to_mont(x, r2, c);
    cur.y = to_mont(y, r2, c);
    cur.z = f_one(c);
  }
#pragma unroll 1
  for (int copy = 1; copy < nu; ++copy) {
#pragma unroll 1
    for (int s = 0; s < shift; ++s) cur = dbl(cur, c);
    const F zi = inv_mont(cur.z, e, ebits, c);
    store_row<F>(ox, first + copy, from_mont(f_mul(cur.x, zi, c), c));
    store_row<F>(oy, first + copy, from_mont(f_mul(cur.y, zi, c), c));
  }
}

// consts: {the consts type's words (ec_field.cuh ConstsWords), r2[L], e[L],
// ebits}.
template <class C>
int launch_precompute(const void* px, const void* py, void* ox, void* oy, int n, int nu,
                      int shift, const unsigned int* consts, cudaStream_t st) {
  constexpr int L = C::kBaseLimbs;
  constexpr int off = ConstsWords<C>::value;
  C c;
  read_consts(consts, c);
  Fp<L> r2, e;
  for (int j = 0; j < L; ++j) {
    r2.v[j] = consts[off + j];
    e.v[j] = consts[off + L + j];
  }
  const int ebits = static_cast<int>(consts[off + 2 * L]);
  precompute_kernel<C><<<(n + kPrecomputeThreads - 1) / kPrecomputeThreads,
                         kPrecomputeThreads, 0, st>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), n, nu, shift, c, r2, e, ebits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The library's degree: build.py compiles this source twice,
// libprecompute_bases over Fp (L = 8, 12, 24) and libprecompute_bases_fp2
// over Fp2 (L = 8, 12) with ICICLE_EC_DEGREE=2.
#ifndef ICICLE_EC_DEGREE
#define ICICLE_EC_DEGREE 1
#endif

extern "C" {

// Launches the kernel on `stream` without synchronising. px, py: device
// pointers, (n, W) uint32; ox, oy: (nu n, W) uint32, W = D L words a
// coordinate. shift >= 0 doublings between copies. L, D: the base field's
// limbs and the coordinate field's degree over it (D must be the library's
// ICICLE_EC_DEGREE). consts: host array {the kernels' consts
// (icicle_msm_prefix_scan's for D), r2[L], (p - 2)[L], bits(p - 2)}.
// Returns the launch's cudaError_t (0 on success).
int icicle_msm_precompute_bases(const void* px, const void* py, void* ox, void* oy, int n,
                                int nu, int shift, int L, int D, const unsigned int* consts,
                                void* stream) {
  if (n < 1 || nu < 1 || shift < 0 || D != ICICLE_EC_DEGREE)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
#if ICICLE_EC_DEGREE == 2
    case 8:
      return launch_precompute<Fp2Consts<8>>(px, py, ox, oy, n, nu, shift, consts, st);
    case 12:
      return launch_precompute<Fp2Consts<12>>(px, py, ox, oy, n, nu, shift, consts, st);
#else
    case 8:
      return launch_precompute<CurveConsts<8>>(px, py, ox, oy, n, nu, shift, consts, st);
    case 12:
      return launch_precompute<CurveConsts<12>>(px, py, ox, oy, n, nu, shift, consts, st);
    case 24:
      return launch_precompute<CurveConsts<24>>(px, py, ox, oy, n, nu, shift, consts, st);
#endif
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
