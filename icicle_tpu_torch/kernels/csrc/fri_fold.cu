// One FRI fold on NVIDIA Hopper (sm_90a): kernel K2 of the port. Bound to
// Python with ctypes (icicle_tpu_torch/kernels/fri_kernel.py: fri_fold).
//
// No Pallas kernel is replaced: the JAX package folds with one jitted XLA
// program (icicle_tpu/ops/fri.py:275 _fold_kernel) over a w^-i table that
// it rebuilds with a Python loop every round (fri.py:296). Here
//   out[i] = (e[i] + e[i+h]) / 2 + alpha (e[i] - e[i+h]) / 2 w^-i,
// h = n / 2, one pair (i, i + h) a thread of a grid-stride loop, so that a
// warp reads 32 consecutive words of each half and writes 32 consecutive
// words. The halving is x >> 1 or (x + p) >> 1 (no multiply); w^-i is the
// domain's inverse-twiddle table (icicle_tpu_torch/ops/ntt.py
// ntt_init_domain, w^-j R mod p for j < 2^(log n0 - 1)) read at stride 2^r
// in round r (omega(k)^2 = omega(k - 1)), already in Montgomery form, so
// that one Montgomery multiply gives (e[i] - e[i+h]) / 2 w^-i canonical;
// alpha comes as alpha R mod p likewise. Two Montgomery multiplies an
// output.
//
// Bound: bytes. n words in, n / 2 twiddles, n / 2 out: 16 MB + 8 + 8 at
// round 0 of a 2^22 prove, 10 us at 3.35 TB/s, against 2^21 x 6 integer
// multiplies (0.75 us at 16.7 T/s).

#include <cstdint>
#include <cuda_runtime.h>

#include "mont32.cuh"

namespace {

constexpr int kThreads = 256;

template <class F>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const uint32_t* __restrict__ in, const uint32_t* __restrict__ tw,
                uint32_t* __restrict__ out, long long half, long long stride,
                uint32_t alpha_mont) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < half;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const uint32_t lo = __ldg(in + i), hi = __ldg(in + half + i);
    const uint32_t even = F::halve(F::add(lo, hi));
    const uint32_t odd = F::mul(F::halve(F::sub(lo, hi)), __ldg(tw + i * stride));
    out[i] = F::add(even, F::mul(odd, alpha_mont));
  }
}

}  // namespace

extern "C" {

// Folds in (2 half,) into out (half,) on `stream` without synchronising.
// p: the field's modulus (babybear or koalabear: a 2-adic ICICLE_M32_FIELDS
// entry). tw: device table of w^-j R mod p, read at j = i stride.
// alpha_mont: alpha R mod p. Returns the launch's cudaError_t.
int icicle_fri_fold(unsigned int p, const void* in, const void* tw, void* out, long long half,
                    long long stride, unsigned int alpha_mont, void* stream) {
  if (half < 1 || stride < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (half + kThreads - 1) / kThreads;
  const unsigned int blocks = static_cast<unsigned int>(want < 4096 ? want : 4096);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ICICLE_FOLD_FIELD(NAME, P)                                                          \
  if (p == (P)) {                                                                           \
    fold_kernel<icicle_m32::Mont32<P>><<<blocks, kThreads, 0, s>>>(                         \
        static_cast<const uint32_t*>(in), static_cast<const uint32_t*>(tw),                 \
        static_cast<uint32_t*>(out), half, stride, alpha_mont);                             \
    return static_cast<int>(cudaGetLastError());                                            \
  }
  ICICLE_FOLD_FIELD(babybear, 0x78000001u)
  ICICLE_FOLD_FIELD(koalabear, 0x7f000001u)
#undef ICICLE_FOLD_FIELD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
