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
// Bound: per slot 11 Montgomery multiplies of 4L^2 + L 32-bit multiplies
// each (264 at L = 8; the two by b3 are add chains) against 5L * 4 bytes
// moved; at L = 8 the multiplies bound it (chip_smoke.py computes both from
// each run's shapes). The extra adds the split below spends are not part of
// the bound.
//
// Design: a scan over K slots with one thread per lane is K dependent adds
// on C threads; at the MSM's shape (K 8192, C 4096) that is one warp per SM
// and latency-bound. So each lane's slots are split into S segments
// (msm_scan.py scan_segments: the smallest power of two with S * C >= 2^16
// threads and S * S <= K), segment s covering slots [s * n, min(K, (s+1) n)),
// n = ceil(K / S), in three passes on one stream:
//   1. scan_reduce: one thread per (segment, lane) folds its slots from the
//      identity with madd and writes the segment's total to `carries`
//      (segments 0..S-2); segment 0's values are final and written to out;
//   2. carry_scan: one thread per lane, carry_0 = identity and
//      carry_{s+1} = padd(carry_s, total_s), in place over `carries`
//      (row s becomes carry_{s+1});
//   3. rescan: one thread per (segment >= 1, lane) re-runs its madds from
//      carry_s and writes every E_k.
// A warp takes 32 consecutive lanes of one segment, so reads and
// writes stay 128 contiguous bytes per limb row. Blocks are kSplitThreads,
// one resident per SM (ec_field.cuh).
// The plain version (prefix_scan_ref) repeats this association of adds, so
// the two agree bit for bit; segment 0 and S = 1 give the serial fold's bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

namespace {

using namespace icicle_ec;

// Slot k's affine point: x then y rows.
template <int L>
__device__ __forceinline__ void load_slot(const uint32_t* in, int k, int lane, size_t row,
                                          Fp<L>& x, Fp<L>& y) {
  const uint32_t* src = in + static_cast<size_t>(k) * 2 * L * row + lane;
  x = load_fp<L>(src, row);
  y = load_fp<L>(src + L * row, row);
}

template <int L>
__device__ __forceinline__ uint32_t* slot_out(uint32_t* out, int k, int lane, size_t row) {
  return out + static_cast<size_t>(k) * 3 * L * row + lane;
}

// Pass 1: blockIdx.y is the segment.
template <int L>
__global__ void __launch_bounds__(kSplitThreads, 1)
scan_reduce_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   uint32_t* __restrict__ carries, int K, int C, int S, int n,
                   const CurveConsts<L> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  const int seg = blockIdx.y;
  const int k0 = min(K, seg * n);
  const int k1 = min(K, k0 + n);
  Point<L> e = identity<L>(c);
  for (int k = k0; k < k1; ++k) {
    Fp<L> x, y;
    load_slot<L>(in, k, lane, row, x, y);
    e = madd<L>(e, x, y, c);
    if (seg == 0) store_point<L>(slot_out<L>(out, k, lane, row), row, e);
  }
  if (seg < S - 1) store_point<L>(carries + static_cast<size_t>(seg) * 3 * L * row + lane, row, e);
}

// Pass 2: one thread per lane over the S - 1 totals.
template <int L>
__global__ void __launch_bounds__(kLaneThreads)
carry_scan_kernel(uint32_t* __restrict__ carries, int C, int S, const CurveConsts<L> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  Point<L> carry = identity<L>(c);
  for (int s = 0; s < S - 1; ++s) {
    uint32_t* p = carries + static_cast<size_t>(s) * 3 * L * row + lane;
    carry = padd<L>(carry, load_point<L>(p, row), c);
    store_point<L>(p, row, carry);
  }
}

// Pass 3: blockIdx.y + 1 is the segment.
template <int L>
__global__ void __launch_bounds__(kSplitThreads, 1)
rescan_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
              const uint32_t* __restrict__ carries, int K, int C, int n,
              const CurveConsts<L> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  const int seg = blockIdx.y + 1;
  const int k0 = min(K, seg * n);
  const int k1 = min(K, k0 + n);
  Point<L> e = load_point<L>(carries + static_cast<size_t>(seg - 1) * 3 * L * row + lane, row);
  for (int k = k0; k < k1; ++k) {
    Fp<L> x, y;
    load_slot<L>(in, k, lane, row, x, y);
    e = madd<L>(e, x, y, c);
    store_point<L>(slot_out<L>(out, k, lane, row), row, e);
  }
}

}  // namespace

extern "C" {

// Launches the scan's passes on `stream` without synchronising. in, out,
// carries: device pointers, (K, 2L, C), (K, 3L, C) and (S - 1, 3L, C)
// uint32 (carries is scratch, unused when S = 1). S: segments per lane,
// 1 <= S <= 65535. consts: host array {p[L], one[L], inv32, b3}. Only
// L = 8 is built. Returns the first refused launch's cudaError_t (0 on
// success).
int icicle_msm_prefix_scan(const void* in, void* out, void* carries, int K, int C, int S,
                           int L, const unsigned int* consts, void* stream) {
  if (L != 8 || K < 1 || C < 1 || S < 1 || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto c = consts_from<8>(consts);
  const auto* src = static_cast<const uint32_t*>(in);
  auto* dst = static_cast<uint32_t*>(out);
  auto* car = static_cast<uint32_t*>(carries);
  const int n = (K + S - 1) / S;
  const int lane_blocks = (C + kSplitThreads - 1) / kSplitThreads;
  const dim3 grid1(lane_blocks, S > 1 ? S - 1 : 1);
  scan_reduce_kernel<8><<<grid1, kSplitThreads, 0, st>>>(src, dst, car, K, C, S, n, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  carry_scan_kernel<8><<<(C + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0, st>>>(
      car, C, S, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rescan_kernel<8><<<dim3(lane_blocks, S - 1), kSplitThreads, 0, st>>>(src, dst, car, K, C, n,
                                                                       c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
