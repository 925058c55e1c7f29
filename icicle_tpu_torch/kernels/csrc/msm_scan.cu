// MSM v3 prefix scan (the E-stream) on NVIDIA Hopper (sm_90a). Bound to
// Python with ctypes (icicle_tpu_torch/kernels/msm_scan.py: prefix_scan).
//
// Replaces the TPU kernel
//   B3  icicle_tpu/pallas/msm_scan.py:45  make_prefix_scan
// computing the same function: per lane, E_0 = identity (0, 1, 0) and
// E_k = E_{k-1} + P_k by the complete mixed add (RCB15 Alg 8, a = 0), with
// E written after every slot.
//   in  (K, 2W, C) uint32: slot k's point in Montgomery form, x in rows
//       0..W-1, y (already negated where the digit is) in rows W..2W-1,
//       W words a coordinate (L over Fp, 2L over Fp2: G2's c0 then c1);
//   out (K, 3W, C) uint32: E_k, x / y / z in rows 0..W-1 / W..2W-1 / 2W..3W-1.
// The Pallas kernel's lane groups and n_groups axis are a VMEM tiling; here
// they are folded into C (n_groups = 1).
//
// Bound: per slot 11 Montgomery multiplies of 4L^2 + L 32-bit multiplies
// each (264 at L = 8, 588 at 12, 2,328 at 24; the two by b3 are add chains)
// against 5L * 4 bytes moved; over Fp2, 11 Fp2 products of three such
// multiplies each, plus the two by b3 where b3 is a general constant,
// against 10L * 4 bytes; the multiplies bound it at every L
// (chip_smoke.py computes both from each run's shapes). At L = 12 and 24 a
// thread's point and temporaries pass the 255-register cap, and ptxas
// spills (its report, in chip_smoke.py's build lines). The extra adds the split below spends are not part of
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
// one resident per SM (ec_field.cuh). The slot loop and the carry scan are
// msm_split.cuh's, shared with the suffix fold (msm_fold2.cu, B6).
// The plain version (prefix_scan_ref) repeats this association of adds, so
// the two agree bit for bit; segment 0 and S = 1 give the serial fold's bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "msm_split.cuh"

namespace {

using namespace icicle_ec;

// The kernels over a coordinate field: C is CurveConsts<L> (Fp<L>) or
// Fp2Consts<L> (Fp2<L>); W = Coord<C>::kWords words a coordinate.
template <class C>
__device__ __forceinline__ uint32_t* slot_out(uint32_t* out, int k, int lane, size_t row) {
  return out + static_cast<size_t>(k) * 3 * Coord<C>::kWords * row + lane;
}

// Pass 1: blockIdx.y is the segment.
template <class C>
__global__ void __launch_bounds__(kSplitThreads, 1)
scan_reduce_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   uint32_t* __restrict__ carries, int K, int lanes, int S, int n, const C c) {
  using F = Coord<C>;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t row = static_cast<size_t>(lanes);
  const int seg = blockIdx.y;
  int k0, k1;
  segment_slots(seg, n, K, k0, k1);
  const ECPoint<F> e = fold_slots<false>(
      in, nullptr, k0, k1, lane, row, identity(c), c,
      [&](int k, int32_t, const ECPoint<F>& acc) {
        if (seg == 0) store_pt<F>(slot_out<C>(out, k, lane, row), row, acc);
      });
  if (seg < S - 1)
    store_pt<F>(carries + static_cast<size_t>(seg) * 3 * F::kWords * row + lane, row, e);
}

// Pass 3: blockIdx.y + 1 is the segment.
template <class C>
__global__ void __launch_bounds__(kSplitThreads, 1)
rescan_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
              const uint32_t* __restrict__ carries, int K, int lanes, int n, const C c) {
  using F = Coord<C>;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t row = static_cast<size_t>(lanes);
  const int seg = blockIdx.y + 1;
  int k0, k1;
  segment_slots(seg, n, K, k0, k1);
  fold_slots<false>(
      in, nullptr, k0, k1, lane, row,
      load_pt<F>(carries + static_cast<size_t>(seg - 1) * 3 * F::kWords * row + lane, row), c,
      [&](int k, int32_t, const ECPoint<F>& acc) {
        store_pt<F>(slot_out<C>(out, k, lane, row), row, acc);
      });
}

}  // namespace

// The library's instance: build.py compiles this source once per (limb
// count, degree) (libmsm_scan: 8, libmsm_scan_l12: 12, libmsm_scan_l24:
// 24 over Fp; libmsm_scan_fp2: 8, libmsm_scan_fp2_l12: 12 over Fp2), so
// that the instances compile in parallel.
#ifndef ICICLE_EC_LIMBS
#define ICICLE_EC_LIMBS 8
#endif
#ifndef ICICLE_EC_DEGREE
#define ICICLE_EC_DEGREE 1
#endif

namespace {

#if ICICLE_EC_DEGREE == 2
using Consts = icicle_ec::Fp2Consts<ICICLE_EC_LIMBS>;
#else
using Consts = icicle_ec::CurveConsts<ICICLE_EC_LIMBS>;
#endif

int launch_scan(const void* in, void* out, void* carries, int K, int lanes, int S,
                const unsigned int* consts, cudaStream_t st) {
  Consts c;
  read_consts(consts, c);
  const auto* src = static_cast<const uint32_t*>(in);
  auto* dst = static_cast<uint32_t*>(out);
  auto* car = static_cast<uint32_t*>(carries);
  const int n = (K + S - 1) / S;
  const int lane_blocks = (lanes + kSplitThreads - 1) / kSplitThreads;
  const dim3 grid1(lane_blocks, S > 1 ? S - 1 : 1);
  scan_reduce_kernel<Consts><<<grid1, kSplitThreads, 0, st>>>(src, dst, car, K, lanes, S, n, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  err = launch_carry_scan(car, lanes, S, c, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  rescan_kernel<Consts><<<dim3(lane_blocks, S - 1), kSplitThreads, 0, st>>>(src, dst, car, K,
                                                                          lanes, n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the scan's passes on `stream` without synchronising. in, out,
// carries: device pointers, (K, 2W, C), (K, 3W, C) and (S - 1, 3W, C)
// uint32, W = D L words a coordinate (carries is scratch, unused when
// S = 1). S: segments per lane, 1 <= S <= 65535. L, D: the limbs of the
// base field and the degree of the coordinate field over it (1: Fp, 2:
// Fp2), which must be the library's ICICLE_EC_LIMBS and ICICLE_EC_DEGREE.
// consts: host array {p[L], one[L], inv32, b3} for D = 1; {p[L], one[L],
// inv32, k, nr, b3[2L]} for D = 2 (ec_field.cuh fp2_consts_from). Returns
// the first refused launch's cudaError_t (0 on success).
int icicle_msm_prefix_scan(const void* in, void* out, void* carries, int K, int C, int S,
                           int L, int D, const unsigned int* consts, void* stream) {
  if (K < 1 || C < 1 || S < 1 || S > 65535 || L != ICICLE_EC_LIMBS || D != ICICLE_EC_DEGREE)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_scan(in, out, carries, K, C, S, consts, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
