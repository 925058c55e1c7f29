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
//   px, py  (n, L) uint32 canonical coordinates, a point a row;
//   ox, oy  (nu n, L) uint32, interleaved: row nu i + j is copy j of P_i;
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
// L = 8, 12 and 24; the C entry dispatches on L.

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

namespace {

using namespace icicle_ec;

// one thread a point; small blocks spread a few thousand points over the SMs
constexpr int kPrecomputeThreads = 64;

template <int L>
__device__ __forceinline__ Fp<L> load_row(const uint32_t* src, size_t i) {
  Fp<L> a;
#pragma unroll
  for (int j = 0; j < L; ++j) a.v[j] = src[i * L + j];
  return a;
}

template <int L>
__device__ __forceinline__ void store_row(uint32_t* dst, size_t i, const Fp<L>& a) {
#pragma unroll
  for (int j = 0; j < L; ++j) dst[i * L + j] = a.v[j];
}

// r2: R^2 mod p; e: p - 2 with ebits bits (the Fermat exponent).
template <int L>
__global__ void __launch_bounds__(kPrecomputeThreads)
precompute_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                  uint32_t* __restrict__ ox, uint32_t* __restrict__ oy, int n, int nu,
                  int shift, const CurveConsts<L> c, const Fp<L> r2, const Fp<L> e,
                  int ebits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp<L> x = load_row<L>(px, i);
  const Fp<L> y = load_row<L>(py, i);
  const size_t first = static_cast<size_t>(nu) * i;
  store_row<L>(ox, first, x);
  store_row<L>(oy, first, y);
  bool inf = true;
#pragma unroll
  for (int j = 0; j < L; ++j) inf = inf && x.v[j] == 0 && y.v[j] == 0;
  Point<L> cur = identity<L>(c);
  if (!inf) {
    cur.x = mont_mul<L>(x, r2, c);
    cur.y = mont_mul<L>(y, r2, c);
#pragma unroll
    for (int j = 0; j < L; ++j) cur.z.v[j] = c.one[j];
  }
  Fp<L> unit;  // 1, canonical: a Montgomery multiply by it leaves the form
#pragma unroll
  for (int j = 0; j < L; ++j) unit.v[j] = j == 0 ? 1u : 0u;
#pragma unroll 1
  for (int copy = 1; copy < nu; ++copy) {
#pragma unroll 1
    for (int s = 0; s < shift; ++s) cur = dbl<L>(cur, c);
    // z^(p-2) in Montgomery form, left to right from 1 (0 -> 0)
    Fp<L> zi;
#pragma unroll
    for (int j = 0; j < L; ++j) zi.v[j] = c.one[j];
#pragma unroll 1
    for (int b = ebits - 1; b >= 0; --b) {
      zi = mont_mul<L>(zi, zi, c);
      if ((e.v[b >> 5] >> (b & 31)) & 1u) zi = mont_mul<L>(zi, cur.z, c);
    }
    store_row<L>(ox, first + copy, mont_mul<L>(mont_mul<L>(cur.x, zi, c), unit, c));
    store_row<L>(oy, first + copy, mont_mul<L>(mont_mul<L>(cur.y, zi, c), unit, c));
  }
}

// consts: {p[L], one[L], inv32, b3, r2[L], e[L], ebits}.
template <int L>
int launch_precompute(const void* px, const void* py, void* ox, void* oy, int n, int nu,
                      int shift, const unsigned int* consts, cudaStream_t st) {
  Fp<L> r2, e;
  for (int j = 0; j < L; ++j) {
    r2.v[j] = consts[2 * L + 2 + j];
    e.v[j] = consts[3 * L + 2 + j];
  }
  const int ebits = static_cast<int>(consts[4 * L + 2]);
  precompute_kernel<L><<<(n + kPrecomputeThreads - 1) / kPrecomputeThreads,
                         kPrecomputeThreads, 0, st>>>(
      static_cast<const uint32_t*>(px), static_cast<const uint32_t*>(py),
      static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy), n, nu, shift,
      consts_from<L>(consts), r2, e, ebits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` without synchronising. px, py: device
// pointers, (n, L) uint32; ox, oy: (nu n, L) uint32. shift >= 0 doublings
// between copies. consts: host array {p[L], one[L], inv32, b3, r2[L],
// (p - 2)[L], bits(p - 2)}. L: 8, 12 or 24. Returns the launch's
// cudaError_t (0 on success).
int icicle_msm_precompute_bases(const void* px, const void* py, void* ox, void* oy, int n,
                                int nu, int shift, int L, const unsigned int* consts,
                                void* stream) {
  if (n < 1 || nu < 1 || shift < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 8:
      return launch_precompute<8>(px, py, ox, oy, n, nu, shift, consts, st);
    case 12:
      return launch_precompute<12>(px, py, ox, oy, n, nu, shift, consts, st);
    case 24:
      return launch_precompute<24>(px, py, ox, oy, n, nu, shift, consts, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
