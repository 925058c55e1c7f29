// One sumcheck round on NVIDIA Hopper (sm_90a): kernel K3 of the port.
// Bound to Python with ctypes (icicle_tpu_torch/kernels/sumcheck_kernel.py:
// sumcheck_round).
//
// No Pallas kernel is replaced: the JAX package computes a round as one
// jitted XLA program (icicle_tpu/ops/sumcheck.py:145 _round_pass), which
// fuses the fold, the deg + 1 combine evaluations and the reductions; eager
// torch would run each as passes over every MLE. Here one pass reads each
// MLE once:
//   in      (npolys, n) canonical MLEs, npolys <= 8;
//   fold    (rounds after the first) each MLE by alpha over stride-2
//           halves: f[i] = e[2i] + alpha (e[2i+1] - e[2i]), stored to
//           `folded` (npolys, n / 2); then the round's pairs are (f[2j],
//           f[2j+1]) of the folded MLEs. Thread j of the grid-stride loop
//           reads the four consecutive e[4j..4j+3] of each MLE (one 16-byte
//           load), folds them to two and stores those (one 8-byte store);
//           without the fold it reads the pair (e[2j], e[2j+1]) (8 bytes);
//   eval    even_q, diff_q = odd_q - even_q into Montgomery form; the
//           combine at k = 0..deg of x_q = even_q + k diff_q (program.cuh),
//           added into deg + 1 per-thread sums;
//   reduce  warp shuffles and shared memory to deg + 1 partial sums a
//           block; the second pass (one block) adds the partials and takes
//           the sums out of Montgomery form into out (deg + 1,).
// Field adds are exact, so the sums equal the JAX package's tree-halving
// reduction bit for bit whatever their order.
//
// Bound: the bytes (npolys n in, npolys n / 2 out with the fold) against
// the Montgomery multiplies (3 integer multiplies each): the fold's, the
// 2 npolys conversions a pair, and deg + 1 combine evaluations a pair.
// AB_MINUS_C over 3 MLEs at 2^24 is 3 x 64 MB in a bytes-bound pass.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont32.cuh"
#include "program.cuh"

namespace {

using icicle_prog::Code;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;  // the wrapper's partials buffer holds kMaxBlocks x 7
constexpr int kMaxPolys = 8;
constexpr int kMaxDeg = 6;

template <class F, int KIND, bool FOLD>
__global__ void __launch_bounds__(kThreads)
    round_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ folded,
                 uint32_t* __restrict__ partials, long long pairs, int npolys, int deg,
                 uint32_t alpha_mont, Code code) {
  uint32_t acc[kMaxDeg + 1];
#pragma unroll
  for (int k = 0; k <= kMaxDeg; ++k) acc[k] = 0;
  const long long in_len = (FOLD ? 4 : 2) * pairs;
  for (long long j = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; j < pairs;
       j += static_cast<long long>(gridDim.x) * kThreads) {
    uint32_t x[kMaxPolys], diff[kMaxPolys];
#pragma unroll
    for (int q = 0; q < kMaxPolys; ++q) {
      if (q >= npolys) break;
      uint32_t e, o;
      if constexpr (FOLD) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(in + q * in_len) + j);
        e = F::add(v.x, F::mul(F::sub(v.y, v.x), alpha_mont));
        o = F::add(v.z, F::mul(F::sub(v.w, v.z), alpha_mont));
        reinterpret_cast<uint2*>(folded + q * 2 * pairs)[j] = make_uint2(e, o);
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(in + q * in_len) + j);
        e = v.x;
        o = v.y;
      }
      x[q] = F::to_mont(e);
      diff[q] = F::sub(F::to_mont(o), x[q]);
    }
#pragma unroll
    for (int k = 0; k <= kMaxDeg; ++k) {
      if (k > deg) break;
      if (k > 0) {
#pragma unroll
        for (int q = 0; q < kMaxPolys; ++q)
          if (q < npolys) x[q] = F::add(x[q], diff[q]);
      }
      acc[k] = F::add(acc[k], icicle_prog::combine<F, KIND>(x, npolys, code));
    }
  }
  __shared__ uint32_t warp_sums[kThreads / 32][kMaxDeg + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k <= kMaxDeg; ++k) {
    if (k > deg) break;
    uint32_t v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = F::add(v, __shfl_down_sync(0xFFFFFFFFu, v, off));
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x <= deg) {
    uint32_t v = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v = F::add(v, warp_sums[w][threadIdx.x]);
    partials[blockIdx.x * (deg + 1) + threadIdx.x] = v;
  }
}

// The second pass: out[k] = from_mont(sum of partials[b][k] over the blocks).
template <class F>
__global__ void __launch_bounds__(kThreads)
    finish_kernel(const uint32_t* __restrict__ partials, int blocks, int deg,
                  uint32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k <= deg; ++k) {
    uint32_t v = 0;
    for (int b = threadIdx.x; b < blocks; b += kThreads) v = F::add(v, partials[b * (deg + 1) + k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = F::add(v, __shfl_down_sync(0xFFFFFFFFu, v, off));
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t s = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) s = F::add(s, warp_sums[w]);
      out[k] = F::from_mont(s);
    }
    __syncthreads();
  }
}

template <class F, int KIND, bool FOLD>
cudaError_t launch(const uint32_t* in, uint32_t* folded, uint32_t* partials, uint32_t* out,
                   long long pairs, int npolys, int deg, uint32_t alpha_mont, const Code& code,
                   cudaStream_t s) {
  const long long want = (pairs + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  round_kernel<F, KIND, FOLD><<<blocks, kThreads, 0, s>>>(in, folded, partials, pairs, npolys,
                                                         deg, alpha_mont, code);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<F><<<1, kThreads, 0, s>>>(partials, blocks, deg, out);
  return cudaGetLastError();
}

template <class F>
cudaError_t dispatch(int kind, int fold, const uint32_t* in, uint32_t* folded,
                     uint32_t* partials, uint32_t* out, long long pairs, int npolys, int deg,
                     uint32_t alpha_mont, const Code& code, cudaStream_t s) {
#define ICICLE_SC_KIND(KIND)                                                                \
  if (kind == icicle_prog::KIND)                                                            \
    return fold ? launch<F, icicle_prog::KIND, true>(in, folded, partials, out, pairs, npolys, \
                                                     deg, alpha_mont, code, s)              \
                : launch<F, icicle_prog::KIND, false>(in, folded, partials, out, pairs,     \
                                                      npolys, deg, alpha_mont, code, s);
  ICICLE_SC_KIND(AB_MINUS_C)
  ICICLE_SC_KIND(EQ_X_AB_MINUS_C)
  ICICLE_SC_KIND(BYTECODE)
#undef ICICLE_SC_KIND
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One round on `stream`, without synchronising. p: the field's modulus (an
// ICICLE_M32_FIELDS entry). in: (npolys, n) device words, n = 4 pairs with
// fold, 2 pairs without; folded: (npolys, 2 pairs) (unused without fold);
// partials: device scratch of kMaxBlocks x (deg + 1) words; out: (deg + 1,)
// device words. kind: 0 AB_MINUS_C, 1 EQ_X_AB_MINUS_C, 2 the bytecode in
// `code` (a host pointer to a Code). alpha_mont: alpha R mod p. Returns
// the launches' cudaError_t (0 on success).
int icicle_sumcheck_round(unsigned int p, const void* in, void* folded, void* partials,
                          void* out, long long pairs, int npolys, int deg, int kind, int fold,
                          unsigned int alpha_mont, const void* code, void* stream) {
  if (pairs < 1 || npolys < 1 || npolys > kMaxPolys || deg < 1 || deg > kMaxDeg)
    return static_cast<int>(cudaErrorInvalidValue);
  const Code& c = *static_cast<const Code*>(code);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ICICLE_SC_FIELD(NAME, P)                                                            \
  if (p == (P))                                                                             \
    return static_cast<int>(dispatch<icicle_m32::Mont32<P>>(                                \
        kind, fold, static_cast<const uint32_t*>(in), static_cast<uint32_t*>(folded),       \
        static_cast<uint32_t*>(partials), static_cast<uint32_t*>(out), pairs, npolys, deg,  \
        alpha_mont, c, s));
  ICICLE_M32_FIELDS(ICICLE_SC_FIELD)
#undef ICICLE_SC_FIELD
  return static_cast<int>(cudaErrorInvalidValue);
}

// kMaxBlocks, so the wrapper sizes the partials buffer from the library.
int icicle_sumcheck_max_blocks() { return kMaxBlocks; }

}  // extern "C"
