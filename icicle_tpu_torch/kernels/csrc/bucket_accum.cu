// MSM v1 bucket accumulation on NVIDIA Hopper (sm_90a). Bound to Python
// with ctypes (icicle_tpu_torch/kernels/msm_kernel.py: bucket_accum).
//
// Replaces the TPU kernel
//   B7  icicle_tpu/pallas/msm_kernel.py:125  make_bucket_accum
// computing the same function: per (window, lane), an inclusive segmented
// fold over the lane's K slots of the window's |digit|-sorted points:
// slot 0 is (x, y, 1); after that a slot is (x, y, 1) again where its key
// differs from the previous slot's, and acc + (x, y) by the complete mixed
// add (RCB15 Alg 8) where it does not. Every slot's value is written.
//   keys (W, K, C) int32;
//   in   (W, K, 2L, C) uint32 Montgomery x || y, y negated where the digit
//        is;
//   out  (W, K, 3L, C) uint32, x / y / z rows.
// The Pallas kernel keeps the limbs limb-first on the sublanes, (W, K, L,
// C) per coordinate; here x || y and x / y / z share one tensor each,
// lane-minor. It multiplies by b3 as a Montgomery constant; ec_field.cuh's
// small-integer add chain gives the same canonical value.
//
// Design: one thread per (window, lane), the accumulator (3L words) in
// registers for all K slots. A reset is a branch: the lane computes the
// mixed add only where it keeps it; the Pallas body computes it every slot
// and selects, with the same kept limbs.
//
// Bound: per slot one mixed add (11 Montgomery multiplies of 4L^2 + L
// 32-bit multiplies; b3 by add chains) against 4 + 5L * 4 bytes moved
// (the key, 2L words in, 3L out). The multiplies bound it; the kernel is
// latency-bound above that: K dependent adds per thread over W * C
// threads (12 * 1024 at the 2^20 shape, three warps per SM).

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

namespace {

using namespace icicle_ec;

template <int L>
__global__ void __launch_bounds__(kLaneThreads)
bucket_accum_kernel(const int32_t* __restrict__ keys, const uint32_t* __restrict__ in,
                    uint32_t* __restrict__ out, int W, int K, int C, const CurveConsts<L> c) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * C) return;
  const int w = t / C;
  const int lane = t - w * C;
  const size_t row = static_cast<size_t>(C);
  const size_t slots = static_cast<size_t>(w) * K;
  Point<L> acc;
  int32_t prev = 0;
  for (int k = 0; k < K; ++k) {
    const size_t s = slots + k;
    const int32_t key = keys[s * row + lane];
    const uint32_t* src = in + s * 2 * L * row + lane;
    Fp<L> x, y;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      x.v[j] = src[j * row];
      y.v[j] = src[(L + j) * row];
    }
    if (k == 0 || key != prev) {
      acc.x = x;
      acc.y = y;
#pragma unroll
      for (int j = 0; j < L; ++j) acc.z.v[j] = c.one[j];
    } else {
      acc = madd<L>(acc, x, y, c);
    }
    prev = key;
    uint32_t* dst = out + s * 3 * L * row + lane;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      dst[j * row] = acc.x.v[j];
      dst[(L + j) * row] = acc.y.v[j];
      dst[(2 * L + j) * row] = acc.z.v[j];
    }
  }
}

}  // namespace

extern "C" {

// Launches the fold on `stream` without synchronising. keys, in, out:
// device pointers, (W, K, C) int32, (W, K, 2L, C) and (W, K, 3L, C)
// uint32. consts: host array {p[L], one[L], inv32, b3}. Only L = 8 is
// built. Returns the launch's cudaError_t (0 on success).
int icicle_msm_bucket_accum(const void* keys, const void* in, void* out, int W, int K, int C,
                            int L, const unsigned int* consts, void* stream) {
  if (L != 8 || W < 1 || K < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = W * C;
  const int blocks = (threads + kLaneThreads - 1) / kLaneThreads;
  bucket_accum_kernel<8><<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const uint32_t*>(in),
      static_cast<uint32_t*>(out), W, K, C, consts_from<8>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
