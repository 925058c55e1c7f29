// The split of a lane's serial axis into segments, shared by the MSM
// kernels over ec_field.cuh that run a running sum of mixed adds: the
// prefix scan (msm_scan.cu, B3), the suffix fold (msm_fold2.cu, B6) and the
// bucket accumulation (bucket_accum.cu, B7).
//
// A lane's K slots are cut into S segments of n = ceil(K / S) slots,
// segment s covering [min(K, s n), min(K, (s + 1) n)). Each kernel folds
// every segment from the identity in a first pass (`fold_slots`; B7's
// segments restart at their first slot and at each key change) and
// writes the totals of segments 0..S-2; `carry_scan_kernel` turns them
// into the carries, carry_{s+1} = padd(carry_s, total_s) from the
// identity, or total_s itself where segment s holds a reset (B7); a third
// pass brings carry_s into segment s >= 1. Blocks of
// the folding passes are kSplitThreads (ec_field.cuh), one resident per
// SM; a warp takes 32 consecutive lanes of one segment, so every limb row
// is read and written 128 contiguous bytes at a time.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

namespace icicle_ec {

// Flag bits of a slot (the suffix fold's; the prefix scan has none).
constexpr int32_t kReal = 1;    // the slot's point is added
constexpr int32_t kRunEnd = 2;  // the slot ends a key's run

// Segment `seg`'s slots [k0, k1) of K, n a segment.
__device__ __forceinline__ void segment_slots(int seg, int n, int K, int& k0, int& k1) {
  k0 = min(K, seg * n);
  k1 = min(K, k0 + n);
}

// Never restarts: every slot's point is added (B3, B6).
struct NoRestart {
  __device__ __forceinline__ bool operator()(int) const { return false; }
};

// e += slot k's point by madd for k in [k0, k1), where the slot's flag has
// kReal (every slot when kFlags is false: flags is then unused); where
// restart(k), e becomes the point (x, y, 1) instead. After each slot,
// visit(k, flag, e). in is (K, 2L, C): x rows then y rows.
template <int L, bool kFlags, class Visit, class Restart = NoRestart>
__device__ __forceinline__ Point<L> fold_slots(const uint32_t* __restrict__ in,
                                               const int32_t* __restrict__ flags, int k0,
                                               int k1, int lane, size_t row, Point<L> e,
                                               const CurveConsts<L>& c, Visit&& visit,
                                               Restart restart = {}) {
  for (int k = k0; k < k1; ++k) {
    const int32_t fl = kFlags ? flags[static_cast<size_t>(k) * row + lane] : kReal;
    if (fl & kReal) {
      const uint32_t* src = in + static_cast<size_t>(k) * 2 * L * row + lane;
      const Fp<L> x = load_fp<L>(src, row);
      const Fp<L> y = load_fp<L>(src + L * row, row);
      if (restart(k)) {
        e.x = x;
        e.y = y;
#pragma unroll
        for (int j = 0; j < L; ++j) e.z.v[j] = c.one[j];
      } else {
        e = madd<L>(e, x, y, c);
      }
    }
    visit(k, fl, e);
  }
  return e;
}

// One thread per lane over the S - 1 segment totals in `carries` ((S - 1,
// 3L, C)), in place: row s becomes carry_{s+1} = padd(carry_s, total_s),
// carry_0 the identity; where `resets` (S rows of C, or null) is nonzero
// at segment s, whose total then starts at a reset, carry_{s+1} = total_s.
template <int L>
__global__ void __launch_bounds__(kLaneThreads)
carry_scan_kernel(uint32_t* __restrict__ carries, const int32_t* __restrict__ resets, int C,
                  int S, const CurveConsts<L> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  Point<L> carry = identity<L>(c);
  for (int s = 0; s < S - 1; ++s) {
    uint32_t* p = carries + static_cast<size_t>(s) * 3 * L * row + lane;
    const Point<L> total = load_point<L>(p, row);
    carry = resets != nullptr && resets[static_cast<size_t>(s) * row + lane] != 0
                ? total
                : padd<L>(carry, total, c);
    store_point<L>(p, row, carry);
  }
}

template <int L>
inline cudaError_t launch_carry_scan(uint32_t* carries, int C, int S, const CurveConsts<L>& c,
                                     cudaStream_t st, const int32_t* resets = nullptr) {
  carry_scan_kernel<L><<<(C + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0, st>>>(
      carries, resets, C, S, c);
  return cudaGetLastError();
}

}  // namespace icicle_ec
