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
// visit(k, flag, e). in is (K, 2W, C): x rows then y rows, W the words of
// the consts' coordinate field.
template <bool kFlags, class C, class Visit, class Restart = NoRestart>
__device__ __forceinline__ ECPoint<Coord<C>> fold_slots(const uint32_t* __restrict__ in,
                                                        const int32_t* __restrict__ flags,
                                                        int k0, int k1, int lane, size_t row,
                                                        ECPoint<Coord<C>> e, const C& c,
                                                        Visit&& visit, Restart restart = {}) {
  using F = Coord<C>;
  constexpr int W = F::kWords;
  for (int k = k0; k < k1; ++k) {
    const int32_t fl = kFlags ? flags[static_cast<size_t>(k) * row + lane] : kReal;
    if (fl & kReal) {
      const uint32_t* src = in + static_cast<size_t>(k) * 2 * W * row + lane;
      const F x = load_coord<F>(src, row);
      const F y = load_coord<F>(src + W * row, row);
      if (restart(k)) {
        e.x = x;
        e.y = y;
        e.z = f_one(c);
      } else {
        e = madd(e, x, y, c);
      }
    }
    visit(k, fl, e);
  }
  return e;
}

// One thread per lane over the S - 1 segment totals in `carries` ((S - 1,
// 3W, C)), in place: row s becomes carry_{s+1} = padd(carry_s, total_s),
// carry_0 the identity; where `resets` (S rows of C, or null) is nonzero
// at segment s, whose total then starts at a reset, carry_{s+1} = total_s.
template <class C>
__global__ void __launch_bounds__(kLaneThreads)
carry_scan_kernel(uint32_t* __restrict__ carries, const int32_t* __restrict__ resets, int lanes,
                  int S, const C c) {
  using F = Coord<C>;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t row = static_cast<size_t>(lanes);
  ECPoint<F> carry = identity(c);
  for (int s = 0; s < S - 1; ++s) {
    uint32_t* p = carries + static_cast<size_t>(s) * 3 * F::kWords * row + lane;
    const ECPoint<F> total = load_pt<F>(p, row);
    carry = resets != nullptr && resets[static_cast<size_t>(s) * row + lane] != 0
                ? total
                : padd(carry, total, c);
    store_pt<F>(p, row, carry);
  }
}

template <class C>
inline cudaError_t launch_carry_scan(uint32_t* carries, int lanes, int S, const C& c,
                                     cudaStream_t st, const int32_t* resets = nullptr) {
  carry_scan_kernel<C><<<(lanes + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0, st>>>(
      carries, resets, lanes, S, c);
  return cudaGetLastError();
}

}  // namespace icicle_ec
