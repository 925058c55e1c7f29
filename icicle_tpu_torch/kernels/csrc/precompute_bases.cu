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
//           copy 0 is the input as given;
//   scratch (nu - 2) 2 W n words where nu > 2, else unused.
// A canonical affine point is unique, so the output equals the plain
// version's (precompute_bases_ref: the port's Group.dbl chain, RCB15 Alg 9,
// and to_affine_canonical) bit for bit whatever the doubling formula.
//
// Bound: operations. The function's least work: per point 2 products into
// Montgomery form (per coordinate-field element); per copy j >= 1 `shift`
// Jacobian doublings (2M + 5S), a share of a batch inversion and the
// products to affine; one inversion for many copies. chip_smoke.py
// (precompute_bound) counts it from each run's shapes, and beside it what
// this kernel does (precompute_kernel.kernel_products).
//
// Design: one thread a point, kThreads points a block. A copy's doublings
// depend on the last, so a point's work is serial and the points are the
// lanes.
// - Arithmetic: ec_wide.cuh's carry-chain Montgomery multiply, values lazy
//   in [0, 2p) between stores (the launch refuses a modulus without two
//   spare bits, as msm_scan.cu's does), every stored coordinate canonical.
// - Doubling: Jacobian at a = 0, dbl-2009-l (ec_wide.cuh jdbl: 7 products
//   over Fp, 16 over Fp2 with the complex squaring), which keeps Z = 0.
// - Inversion: Montgomery's batch inversion, one Fermat power a block.
//   Forward, a thread multiplies its copies' Z (a Z of 0 enters as one)
//   into c, keeping each copy's X, Y (in its output rows), Z and the
//   product before it (in scratch, lane-minor) for the walk back; its last
//   copy stays in registers, so nu = 2 (E4) touches no scratch. The block
//   then inverts its threads' c through a product tree in shared memory
//   (up: kThreads - 1 products in log2 kThreads levels; thread 0 takes
//   the root's Fermat power; down: 2 products a node), over Fp; an Fp2 c
//   goes in as its norm c0^2 - nr c1^2 and comes out as conj(c) / norm.
//   Backward, each copy's Z^-1 is the inverse times the product before it,
//   and the inverse times Z the next inverse.
// - To affine, out of Montgomery form with it: with zi = Z^-1 R and zp =
//   Z^-1 (zi times 1), s2 = zi zp R^-1 = Z^-2 and s3 = s2 zi R^-1 = Z^-3
//   are plain, so X R s2 R^-1 = X Z^-2 is the output itself: 5 products a
//   copy, then canonical.
// - Launch: kThreads threads, __launch_bounds__(kThreads, 1), ptxas's
//   registers and spills in PERF.md. M3's 1,024 points fill 8 blocks: its
//   time is one thread's serial chain (a warp a scheduler), which smaller
//   blocks would not shorten.
// Instantiated for L = 8, 12 and 24 over Fp, and for L = 8 and 12 over
// Fp2 (G2 of bn254, bls12_377, bls12_381); bw6_761's G2 takes the 24-limb
// instance with its own constants (b does not enter a doubling). The C
// entry dispatches on L.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

#include "ec_wide.cuh"

namespace {

using namespace icicle_ec;

constexpr int kThreads = 128;

// ec_wide.cuh's consts for ec_field.cuh's consts type C (WideFp, WideFp2).
template <class C>
using Wide = decltype(wide::wide_consts(std::declval<C>()));

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

// Element `slot` of thread i in lane-minor scratch: word j at
// src[(slot W + j) n + i], so a warp's lanes touch neighbouring words.
template <class F>
__device__ __forceinline__ F load_slot(const uint32_t* src, size_t slot, int n, int i) {
  F a;
#pragma unroll
  for (int j = 0; j < F::kWords; ++j) a.w(j) = src[(slot * F::kWords + j) * n + i];
  return a;
}

template <class F>
__device__ __forceinline__ void store_slot(uint32_t* dst, size_t slot, int n, int i,
                                           const F& a) {
#pragma unroll
  for (int j = 0; j < F::kWords; ++j) dst[(slot * F::kWords + j) * n + i] = a.w(j);
}

template <int L>
__device__ __forceinline__ bool is_zero(const Fp<L>& a) {
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) any |= a.v[j];
  return any == 0;
}

template <int L>
__device__ __forceinline__ bool is_zero(const Fp2<L>& a) {
  return is_zero<L>(a.c0) && is_zero<L>(a.c1);
}

template <class F>
__device__ __forceinline__ F pick(bool first, const F& a, const F& b) {
  F r;
#pragma unroll
  for (int j = 0; j < F::kWords; ++j) r.w(j) = first ? a.w(j) : b.w(j);
  return r;
}

// The base field's plain 1: a Montgomery multiply by it leaves the form.
template <int L>
__device__ __forceinline__ Fp<L> unit() {
  Fp<L> u;
#pragma unroll
  for (int j = 0; j < L; ++j) u.v[j] = j == 0 ? 1u : 0u;
  return u;
}

// The field steps over Fp (WideFp) and Fp2 (WideFp2); r2: R^2 mod p.
template <int L>
__device__ __forceinline__ Fp<L> to_mont(const Fp<L>& a, const Fp<L>& r2,
                                         const wide::WideFp<L>& k) {
  return wide::mul<L>(a, r2, k.f);
}

template <int L>
__device__ __forceinline__ Fp2<L> to_mont(const Fp2<L>& a, const Fp<L>& r2,
                                          const wide::WideFp2<L>& k) {
  return {wide::mul<L>(a.c0, r2, k.f), wide::mul<L>(a.c1, r2, k.f)};
}

template <int L>
__device__ __forceinline__ Fp<L> from_mont(const Fp<L>& a, const wide::WideFp<L>& k) {
  return wide::mul<L>(a, unit<L>(), k.f);
}

template <int L>
__device__ __forceinline__ Fp2<L> from_mont(const Fp2<L>& a, const wide::WideFp2<L>& k) {
  return {wide::mul<L>(a.c0, unit<L>(), k.f), wide::mul<L>(a.c1, unit<L>(), k.f)};
}

// What a thread's product c sends to the block's tree (an element of Fp),
// and c^-1 from that element's inverse.
template <int L>
__device__ __forceinline__ Fp<L> tree_leaf(const Fp<L>& c, const wide::WideFp<L>&) {
  return c;
}

template <int L>
__device__ __forceinline__ Fp<L> tree_leaf(const Fp2<L>& c, const wide::WideFp2<L>& k) {
  return wide::add<L>(wide::mul<L>(c.c0, c.c0, k.f),
                      wide::mul_small<L>(wide::mul<L>(c.c1, c.c1, k.f), -k.nr, k.f), k.f);
}

template <int L>
__device__ __forceinline__ Fp<L> from_leaf(const Fp<L>&, const Fp<L>& li,
                                           const wide::WideFp<L>&) {
  return li;
}

template <int L>
__device__ __forceinline__ Fp2<L> from_leaf(const Fp2<L>& c, const Fp<L>& li,
                                            const wide::WideFp2<L>& k) {
  Fp<L> zero;
#pragma unroll
  for (int j = 0; j < L; ++j) zero.v[j] = 0;
  return {wide::mul<L>(c.c0, li, k.f), wide::sub<L>(zero, wide::mul<L>(c.c1, li, k.f), k.f)};
}

// z^(p-2) in Montgomery form, left to right from 1 (e = p - 2, ebits bits).
template <int L>
__device__ Fp<L> fermat(const Fp<L>& z, const Fp<L>& e, int ebits,
                        const wide::BaseConsts<L>& f) {
  Fp<L> zi;
#pragma unroll
  for (int j = 0; j < L; ++j) zi.v[j] = f.one[j];
#pragma unroll 1
  for (int b = ebits - 1; b >= 0; --b) {
    zi = wide::mul<L>(zi, zi, f);
    if ((e.v[b >> 5] >> (b & 31)) & 1u) zi = wide::mul<L>(zi, z, f);
  }
  return zi;
}

// The block's batch inversion: every thread's leaf in, its inverse out,
// through the product tree node[1 .. 2 kThreads) (node i's children 2i and
// 2i + 1, the leaves at kThreads + thread), word j of node i at
// node[j][i]. Every thread of the block calls it.
template <int L>
__device__ __forceinline__ Fp<L> block_inverse(const Fp<L>& leaf, uint32_t (*node)[2 * kThreads],
                                               const Fp<L>& e, int ebits,
                                               const wide::BaseConsts<L>& f) {
  const int t = threadIdx.x;
  auto get = [&](int i) {
    Fp<L> a;
#pragma unroll
    for (int j = 0; j < L; ++j) a.v[j] = node[j][i];
    return a;
  };
  auto put = [&](int i, const Fp<L>& a) {
#pragma unroll
    for (int j = 0; j < L; ++j) node[j][i] = a.v[j];
  };
  put(kThreads + t, leaf);
#pragma unroll 1
  for (int half = kThreads / 2; half >= 1; half /= 2) {
    __syncthreads();
    if (t < half) put(half + t, wide::mul<L>(get(2 * (half + t)), get(2 * (half + t) + 1), f));
  }
  __syncthreads();
  if (t == 0) put(1, fermat<L>(get(1), e, ebits, f));
#pragma unroll 1
  for (int half = 1; half < kThreads; half *= 2) {
    __syncthreads();
    if (t < half) {
      const int i = half + t;
      const Fp<L> inv = get(i), a = get(2 * i), b = get(2 * i + 1);
      put(2 * i, wide::mul<L>(inv, b, f));
      put(2 * i + 1, wide::mul<L>(inv, a, f));
    }
  }
  __syncthreads();
  return get(kThreads + t);
}

// Copy `row`'s canonical affine coordinates from its Jacobian X, Y (lazy,
// Montgomery form) and zi = Z^-1 R; (0, 0) where Z was 0.
template <class K>
__device__ __forceinline__ void store_affine(uint32_t* ox, uint32_t* oy, size_t row,
                                             const typename K::F& x, const typename K::F& y,
                                             const typename K::F& zi, bool zero, const K& k) {
  using F = typename K::F;
  const F zp = from_mont(zi, k);
  const F s2 = wide::fmul(zi, zp, k);
  const F s3 = wide::fmul(s2, zi, k);
  const F z = wide::fzero(k);
  store_row<F>(ox, row, pick(zero, z, wide::fcanonical(wide::fmul(x, s2, k), k)));
  store_row<F>(oy, row, pick(zero, z, wide::fcanonical(wide::fmul(y, s3, k), k)));
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
precompute_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                  uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                  uint32_t* __restrict__ scratch, int n, int nu, int shift, const Wide<C> k,
                  const Fp<C::kBaseLimbs> r2, const Fp<C::kBaseLimbs> e, int ebits) {
  using F = Coord<C>;
  constexpr int L = C::kBaseLimbs;
  __shared__ uint32_t node[L][2 * kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const size_t first = static_cast<size_t>(nu) * i;
  // c: the product of this thread's copies' Z (one where Z = 0); the last
  // copy's X, Y, Z and the product before it stay in registers
  F c = wide::fone(k), cprev = c;
  ECPoint<F> cur = wide::identity(k);
  if (live) {
    const F x = load_row<F>(px, i);
    const F y = load_row<F>(py, i);
    store_row<F>(ox, first, x);
    store_row<F>(oy, first, y);
    cur.x = to_mont(x, r2, k);
    cur.y = to_mont(y, r2, k);
    cur.z = pick(is_zero(x) && is_zero(y), wide::fzero(k), wide::fone(k));
#pragma unroll 1
    for (int copy = 1; copy < nu; ++copy) {
#pragma unroll 1
      for (int s = 0; s < shift; ++s) cur = wide::jdbl(cur, k);
      const F z1 = pick(is_zero(wide::fcanonical(cur.z, k)), wide::fone(k), cur.z);
      cprev = c;
      c = copy == 1 ? z1 : wide::fmul(c, z1, k);
      if (copy < nu - 1) {  // kept for the walk back: X, Y in the copy's rows
        store_row<F>(ox, first + copy, cur.x);
        store_row<F>(oy, first + copy, cur.y);
        store_slot<F>(scratch, 2 * (copy - 1), n, i, cur.z);
        store_slot<F>(scratch, 2 * (copy - 1) + 1, n, i, cprev);
      }
    }
  }
  if (nu < 2) return;  // the same in every thread of the block
  const Fp<L> li = block_inverse<L>(tree_leaf(c, k), node, e, ebits, k.f);
  if (!live) return;
  F inv = from_leaf(c, li, k);  // (Z_1 .. Z_copy)^-1 R, copy from nu - 1 down
  {
    const bool zero = is_zero(wide::fcanonical(cur.z, k));
    const F zi = nu == 2 ? inv : wide::fmul(inv, cprev, k);
    if (nu > 2) inv = wide::fmul(inv, pick(zero, wide::fone(k), cur.z), k);
    store_affine(ox, oy, first + nu - 1, cur.x, cur.y, zi, zero, k);
  }
#pragma unroll 1
  for (int copy = nu - 2; copy >= 1; --copy) {
    const F z = load_slot<F>(scratch, 2 * (copy - 1), n, i);
    const bool zero = is_zero(wide::fcanonical(z, k));
    const F zi = copy == 1 ? inv
                           : wide::fmul(inv, load_slot<F>(scratch, 2 * copy - 1, n, i), k);
    if (copy > 1) inv = wide::fmul(inv, pick(zero, wide::fone(k), z), k);
    store_affine(ox, oy, first + copy, load_row<F>(ox, first + copy),
                 load_row<F>(oy, first + copy), zi, zero, k);
  }
}

// consts: {the consts type's words (ec_field.cuh ConstsWords), r2[L], e[L],
// ebits}.
template <class C>
int launch_precompute(const void* px, const void* py, void* ox, void* oy, void* scratch,
                      int n, int nu, int shift, const unsigned int* consts, cudaStream_t st) {
  constexpr int L = C::kBaseLimbs;
  constexpr int off = ConstsWords<C>::value;
  C c;
  read_consts(consts, c);
  const Wide<C> k = wide::wide_consts(c);
  if (!wide::lazy_ok(k.f) || (nu > 2 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Fp<L> r2, e;
  for (int j = 0; j < L; ++j) {
    r2.v[j] = consts[off + j];
    e.v[j] = consts[off + L + j];
  }
  const int ebits = static_cast<int>(consts[off + 2 * L]);
  precompute_kernel<C><<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), static_cast<uint32_t*>(scratch),
      n, nu, shift, k, r2, e, ebits);
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
// coordinate; scratch: (nu - 2) 2 W n uint32 where nu > 2, else unused
// (may be null). shift >= 0 doublings between copies. L, D: the base
// field's limbs and the coordinate field's degree over it (D must be the
// library's ICICLE_EC_DEGREE). consts: host array {the kernels' consts
// (icicle_msm_prefix_scan's for D), r2[L], (p - 2)[L], bits(p - 2)}; the
// modulus must leave two bits spare (4p < 2^(32 L)). Returns the launch's
// cudaError_t (0 on success).
int icicle_msm_precompute_bases(const void* px, const void* py, void* ox, void* oy,
                                void* scratch, int n, int nu, int shift, int L, int D,
                                const unsigned int* consts, void* stream) {
  if (n < 1 || nu < 1 || shift < 0 || D != ICICLE_EC_DEGREE)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
#if ICICLE_EC_DEGREE == 2
    case 8:
      return launch_precompute<Fp2Consts<8>>(px, py, ox, oy, scratch, n, nu, shift, consts, st);
    case 12:
      return launch_precompute<Fp2Consts<12>>(px, py, ox, oy, scratch, n, nu, shift, consts, st);
#else
    case 8:
      return launch_precompute<CurveConsts<8>>(px, py, ox, oy, scratch, n, nu, shift, consts, st);
    case 12:
      return launch_precompute<CurveConsts<12>>(px, py, ox, oy, scratch, n, nu, shift, consts,
                                                st);
    case 24:
      return launch_precompute<CurveConsts<24>>(px, py, ox, oy, scratch, n, nu, shift, consts,
                                                st);
#endif
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
