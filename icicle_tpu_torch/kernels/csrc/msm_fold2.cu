// MSM v2 suffix fold on NVIDIA Hopper (sm_90a): its scan and run-end
// passes. Bound to Python with ctypes (icicle_tpu_torch/kernels/
// msm_fold2.py: suffix_fold, which then sums the run ends with B4,
// ec_reduce.cu).
//
// Replaces the TPU kernel
//   B6  icicle_tpu/pallas/msm_fold2.py:75  make_suffix_fold
// computing the same function: per lane (one tile of one window, its slots
// sorted by |digit| descending, a dummy slot for every key), two
// accumulators from the identity (0, 1, 0):
//   E += P_k  by the complete mixed add (RCB15 Alg 8)  where bit 0 (is_real);
//   D += E    by the complete projective add (Alg 7)   where bit 1 (is_dacc,
//             the last slot of a key's run),
// so that D ends as the tile's weighted window sum sum_k k B_k.
//   in    (K, 2L, C) uint32 Montgomery x || y, y already negated where the
//         digit is (the prepared +-P table; the Pallas kernel's flag bit 2
//         is consumed by that gather, not here);
//   flags (K, C) int32, bit 0 is_real, bit 1 is_dacc;
//   out   (3L, C) uint32: D, x / y / z rows (written by B4).
// The Pallas kernel takes bf16 coordinate bytes (its matrix-unit permute's
// output) in an (n_groups, K, 8L + 8, G) layout; here the limbs come as
// int32 from a gather and the lane groups are folded into C.
//
// Design. D is the sum of E at the lane's run ends, so the fold is a scan
// of E that stores E at each run end, then a reduction of those rows. One
// thread a lane over K slots is latency-bound (C = 8192 lanes: two warps an
// SM), and a projective add inside the slot loop runs for a warp whenever
// one of its lanes ends a run (on the v2 stream a lane ends a run one slot
// in nine, so almost every slot). Instead, with msm_split.cuh's segments
// (S per lane, msm_fold2.py fold_segments):
//   1. fold: one thread per (segment, lane) folds its slots from the
//      identity by madd where bit 0, and at each slot with bit 1 stores E
//      (3L words, the only work under that branch) to row `rank` of `ends`
//      (R, 3L, C); writes the totals of segments 0..S-2 to `carries`.
//      The ranks come from `starts` (S, C): a lane's run ends fill the LAST
//      rows of `ends` in slot order, starts[s] = R - (run ends in the lane)
//      + (run ends before segment s); segment 0's thread fills the rows
//      before them with the identity. A rank below 0 (more run ends than R
//      rows) is not stored, so no store leaves the buffer for any flags;
//   2. carry scan (msm_split.cuh);
//   3. fixup: one thread per (row, lane); a row stored by segment s >= 1
//      becomes padd(carry_s, row): about R (S-1)/S adds a lane, where a
//      rescan of the segments from their carries (as B3's pass 3) would
//      redo about K (S-1)/S (PERF.md: 19 ms against 12 at the 2^24 shape);
//   4. D = B4 over the R rows (msm_fold2.py), with B4's own plan. Leading
//      identity rows leave B4's serial fold bit-exact: padd of the identity
//      (0, 1, 0) and itself is (0, 1, 0), so at S = 1 the adds are those of
//      the serial fold, in its order.
// The plain version (suffix_fold_ref) repeats this association, so the two
// agree bit for bit at the same S.
//
// Bound: a mixed add (11 Montgomery multiplies of 4L^2 + L 32-bit
// multiplies) per real slot and a projective add (12) per run end, the
// multiplies by b3 being add chains; against the points and flags read and
// D written. The multiplies bound it. chip_smoke.py counts both from each
// run's flags; the split's extra adds (carries, pass 3, B4's tree) are not
// part of the bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "msm_split.cuh"

namespace {

using namespace icicle_ec;

template <int L>
__device__ __forceinline__ uint32_t* end_row(uint32_t* ends, int rank, int lane, size_t row) {
  return ends + static_cast<size_t>(rank) * 3 * L * row + lane;
}

// Pass 1: blockIdx.y is the segment.
template <int L>
__global__ void __launch_bounds__(kSplitThreads, 1)
fold_kernel(const uint32_t* __restrict__ in, const int32_t* __restrict__ flags,
            const int32_t* __restrict__ starts, uint32_t* __restrict__ ends,
            uint32_t* __restrict__ carries, int K, int C, int S, int n,
            const CurveConsts<L> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  const int seg = blockIdx.y;
  int rank = starts[static_cast<size_t>(seg) * row + lane];
  const Point<L> id = identity<L>(c);
  if (seg == 0)
    for (int r = 0; r < rank; ++r) store_point<L>(end_row<L>(ends, r, lane, row), row, id);
  int k0, k1;
  segment_slots(seg, n, K, k0, k1);
  const Point<L> e = fold_slots<L, true>(
      in, flags, k0, k1, lane, row, id, c, [&](int, int32_t fl, const Point<L>& acc) {
        if (fl & kRunEnd) {
          if (rank >= 0) store_point<L>(end_row<L>(ends, rank, lane, row), row, acc);
          ++rank;
        }
      });
  if (seg < S - 1) store_point<L>(carries + static_cast<size_t>(seg) * 3 * L * row + lane, row, e);
}

// Pass 3: one thread per (row, lane), rows striding by gridDim.y.
// Row r belongs to the last segment s with starts[s] <= r (starts do not
// decrease with s); where s >= 1 it becomes padd(carry_s, row).
template <int L>
__global__ void __launch_bounds__(kSplitThreads, 1)
fixup_kernel(uint32_t* __restrict__ ends, const uint32_t* __restrict__ carries,
             const int32_t* __restrict__ starts, int C, int S, int R, const CurveConsts<L> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    int seg = 0;
    for (int s = 1; s < S; ++s)
      if (starts[static_cast<size_t>(s) * row + lane] <= r) seg = s;
    if (seg == 0) continue;
    uint32_t* p = end_row<L>(ends, r, lane, row);
    const Point<L> carry =
        load_point<L>(carries + static_cast<size_t>(seg - 1) * 3 * L * row + lane, row);
    store_point<L>(p, row, padd<L>(carry, load_point<L>(p, row), c));
  }
}

}  // namespace

extern "C" {

// Launches passes 1-3 on `stream` without synchronising. in, flags,
// starts, ends, carries: device pointers, (K, 2L, C) uint32, (K, C) int32,
// (S, C) int32, (R, 3L, C) uint32 (every row written) and (S - 1, 3L, C)
// uint32 (scratch, unused when S = 1). S: segments per lane, 1 <= S <=
// 65535. consts: host array {p[L], one[L], inv32, b3}. Only L = 8 is
// built. Returns the first refused launch's cudaError_t (0 on success).
int icicle_msm_suffix_fold(const void* in, const void* flags, const void* starts, void* ends,
                           void* carries, int K, int C, int S, int R, int L,
                           const unsigned int* consts, void* stream) {
  if (L != 8 || K < 1 || C < 1 || S < 1 || S > 65535 || R < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto c = consts_from<8>(consts);
  const auto* st0 = static_cast<const int32_t*>(starts);
  auto* out = static_cast<uint32_t*>(ends);
  auto* car = static_cast<uint32_t*>(carries);
  const int lane_blocks = (C + kSplitThreads - 1) / kSplitThreads;
  fold_kernel<8><<<dim3(lane_blocks, S), kSplitThreads, 0, st>>>(
      static_cast<const uint32_t*>(in), static_cast<const int32_t*>(flags), st0, out, car, K, C,
      S, (K + S - 1) / S, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  err = launch_carry_scan<8>(car, C, S, c, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  fixup_kernel<8><<<dim3(lane_blocks, R < 65535 ? R : 65535), kSplitThreads, 0, st>>>(
      out, car, st0, C, S, R, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
