// MSM v3 prefix scan (the E-stream) on NVIDIA Hopper (sm_90a). Bound to
// Python with ctypes (icicle_tpu_torch/kernels/msm_scan.py: prefix_scan).
//
// Replaces the TPU kernel
//   B3  icicle_tpu/pallas/msm_scan.py:45  make_prefix_scan
// computing the same function: per lane, E_0 = identity (0, 1, 0) and
// E_k = E_{k-1} + P_k by the complete mixed add (RCB15 Alg 8, a = 0), with
// E written after every slot.
//   in  (K, 2L, C) uint32: slot k's point in Montgomery form, x in rows
//       0..L-1, y (already negated where the digit is) in rows L..2L-1;
//   out (K, 3L, C) uint32: E_k, x / y / z in rows 0..L-1 / L..2L-1 / 2L..3L-1.
// The Pallas kernel's lane groups and n_groups axis are a VMEM tiling; here
// they are folded into C (n_groups = 1).
//
// Design: one thread per lane. E (3L words) stays in registers for all K
// slots; each slot reads 2L words and writes 3L, lane-minor, so a warp's
// 32 lanes read and write 128 contiguous bytes per limb row.
//
// Bound: per slot 11 Montgomery multiplies of 4L^2 + L 32-bit multiplies
// each (264 at L = 8; the two by b3 are add chains) against 5L * 4 bytes
// moved; at L = 8 the multiplies bound it (chip_smoke.py computes both from
// each run's shapes). The kernel is far from that bound at the MSM's
// shapes: K = 8192 dependent
// adds per thread over only C = 4096 threads (1.5% of the card's resident
// threads). Splitting K across threads with a carry fix-up pass is a
// later change.

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

namespace {

using namespace icicle_ec;

template <int L>
__global__ void __launch_bounds__(kLaneThreads)
prefix_scan_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   int K, int C, const CurveConsts<L> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  Point<L> e = identity<L>(c);
  for (int k = 0; k < K; ++k) {
    const uint32_t* src = in + static_cast<size_t>(k) * 2 * L * row + lane;
    Fp<L> x, y;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      x.v[j] = src[j * row];
      y.v[j] = src[(L + j) * row];
    }
    e = madd<L>(e, x, y, c);
    uint32_t* dst = out + static_cast<size_t>(k) * 3 * L * row + lane;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      dst[j * row] = e.x.v[j];
      dst[(L + j) * row] = e.y.v[j];
      dst[(2 * L + j) * row] = e.z.v[j];
    }
  }
}

}  // namespace

extern "C" {

// Launches the scan on `stream` without synchronising. in, out: device
// pointers, (K, 2L, C) and (K, 3L, C) uint32. consts: host array
// {p[L], one[L], inv32, b3}. Only L = 8 is built. Returns the launch's
// cudaError_t (0 on success).
int icicle_msm_prefix_scan(const void* in, void* out, int K, int C, int L,
                           const unsigned int* consts, void* stream) {
  if (L != 8 || K < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (C + kLaneThreads - 1) / kLaneThreads;
  prefix_scan_kernel<8><<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), K, C,
      consts_from<8>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
