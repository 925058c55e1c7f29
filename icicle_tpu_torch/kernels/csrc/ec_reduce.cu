// Lane-parallel sum of projective EC points on NVIDIA Hopper (sm_90a).
// Bound to Python with ctypes (icicle_tpu_torch/kernels/ec_reduce.py:
// ec_reduce).
//
// Replaces the TPU kernel
//   B4  icicle_tpu/pallas/ec_reduce.py:63  make_ec_reduce
// computing the same function: per lane, the sum over R rows by the
// complete projective add (RCB15 Alg 7, a = 0), starting from the identity
// (0, 1, 0) as the Pallas kernel does (ec_reduce.py:106-111).
//   in  (R, 3L, C) uint32 projective Montgomery points, x / y / z in rows
//       0..L-1 / L..2L-1 / 2L..3L-1;
//   out (3L, C) uint32.
// The Pallas kernel pads C to 128 lanes and R to a multiple of its VMEM
// row block with identity points; neither is needed here (each added
// identity would scale the projective coordinates by Y).
//
// Design: one thread per lane, the accumulator (3L words) in registers,
// rows read lane-minor so a warp's reads coalesce.
//
// Bound: per row 12 Montgomery multiplies of 4L^2 + L 32-bit multiplies
// each (the two by b3 are add chains) against 3L * 4 bytes read; at L = 8
// the multiplies bound it (chip_smoke.py computes both from each run's
// shapes). The MSM's cross-tile fold gives each of C = 2048 threads R = 2048 dependent adds,
// far from that bound; a tree over R is a later change.

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

namespace {

using namespace icicle_ec;

template <int L>
__device__ __forceinline__ Fp<L> load_fp(const uint32_t* src, size_t row) {
  Fp<L> a;
#pragma unroll
  for (int j = 0; j < L; ++j) a.v[j] = src[j * row];
  return a;
}

template <int L>
__global__ void __launch_bounds__(kLaneThreads)
ec_reduce_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int R, int C, const CurveConsts<L> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  Point<L> acc = identity<L>(c);
  for (int r = 0; r < R; ++r) {
    const uint32_t* src = in + static_cast<size_t>(r) * 3 * L * row + lane;
    Point<L> q;
    q.x = load_fp<L>(src, row);
    q.y = load_fp<L>(src + L * row, row);
    q.z = load_fp<L>(src + 2 * L * row, row);
    acc = padd<L>(acc, q, c);
  }
  uint32_t* dst = out + lane;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    dst[j * row] = acc.x.v[j];
    dst[(L + j) * row] = acc.y.v[j];
    dst[(2 * L + j) * row] = acc.z.v[j];
  }
}

}  // namespace

extern "C" {

// Launches the reduction on `stream` without synchronising. in, out: device
// pointers, (R, 3L, C) and (3L, C) uint32. consts: host array
// {p[L], one[L], inv32, b3}. Only L = 8 is built. Returns the launch's
// cudaError_t (0 on success).
int icicle_msm_ec_reduce(const void* in, void* out, int R, int C, int L,
                         const unsigned int* consts, void* stream) {
  if (L != 8 || R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (C + kLaneThreads - 1) / kLaneThreads;
  ec_reduce_kernel<8><<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), R, C,
      consts_from<8>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
