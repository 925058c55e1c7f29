// MSM v1 bucket accumulation on NVIDIA Hopper (sm_90a). Bound to Python
// with ctypes (icicle_tpu_torch/kernels/msm_kernel.py: bucket_accum).
//
// Replaces the TPU kernel
//   B7  icicle_tpu/pallas/msm_kernel.py:125  make_bucket_accum
// computing the same function at the rows its caller reads: per (window,
// lane), an inclusive segmented fold over the lane's K slots of the
// window's |digit|-sorted points: slot 0 is (x, y, 1); after that a slot is
// (x, y, 1) again where its key differs from the previous slot's, and
// acc + (x, y) by the complete mixed add (RCB15 Alg 8) where it does not.
// The value is written only at the run ends (a slot whose key differs from
// the next slot's) and at each lane's last slot: the rows that v1's bucket
// phase reads (ops/msm_tpu.py _bucket_phase). Other rows are not written.
//   keys (W, K, C) int32;
//   in   (W, K, 2L, C) uint32 Montgomery x || y, y negated where the digit
//        is;
//   out  (W, K, 3L, C) uint32, x / y / z rows, at the rows above.
// The Pallas kernel writes every slot, keeps the limbs limb-first on the
// sublanes, (W, K, L, C) per coordinate, and multiplies by b3 as a
// Montgomery constant; here x || y and x / y / z share one tensor each,
// lane-minor, and ec_field.cuh's small-integer add chain gives the same
// canonical value.
//
// Design. One thread per (window, lane) over all K slots is K dependent
// adds on W * C threads (12 * 1024 at the 2^20 shape: three warps an SM)
// and writes every slot (1.2 GB a launch). Instead, with msm_split.cuh's
// segments (S per lane, msm_kernel.py accum_segments: 8 at the 2^20
// shape), in three passes:
//   1. accum: one thread per (segment, window, lane) runs the serial fold
//      over its slots, restarting at its first slot as at every key
//      change, and stores the value at its run ends. It writes its total
//      (the value since its last restart) to `carries` (segments 0..S-2),
//      whether it holds a reset (a slot whose key differs from the one
//      before, or slot 0) to `resets`, and, for s >= 1, the slot of its
//      first stored row where that row's run began in an earlier segment,
//      else -1, to `fix`;
//   2. carry scan (msm_split.cuh): carry_{s+1} = total_s where segment s
//      holds a reset, else padd(carry_s, total_s);
//   3. fixup: one thread per (segment >= 1, window, lane) adds carry_s into
//      its `fix` row: padd(carry_s, row), one add a segment at most.
// The plain version (bucket_accum_ref) repeats this association, so the
// two agree bit for bit at the same S; at S = 1 both are the serial fold
// of the JAX twin make_bucket_accum_xla at the rows written.
//
// Bound: per slot that continues a run one mixed add (11 Montgomery
// multiplies of 4L^2 + L 32-bit multiplies; b3 by add chains), against
// the keys and points read and the written rows' 3L words. The multiplies
// bound it (chip_smoke.py counts both from each run's keys).

#include <cstdint>
#include <cuda_runtime.h>

#include "msm_split.cuh"

namespace {

using namespace icicle_ec;

// Pass 1: blockIdx.y is the segment; x runs over the W * C (window, lane)
// pairs, the scratch arrays' lane index.
template <int L>
__global__ void __launch_bounds__(kSplitThreads, 1)
accum_kernel(const int32_t* __restrict__ keys, const uint32_t* __restrict__ in,
             uint32_t* __restrict__ out, uint32_t* __restrict__ carries,
             int32_t* __restrict__ resets, int32_t* __restrict__ fix, int W, int K, int C,
             int S, int n, const CurveConsts<L> c) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * C) return;
  const int w = t / C;
  const int lane = t - w * C;
  const size_t row = static_cast<size_t>(C);
  const size_t pairs = static_cast<size_t>(W) * C;
  const int seg = blockIdx.y;
  int k0, k1;
  segment_slots(seg, n, K, k0, k1);
  const int32_t* key = keys + static_cast<size_t>(w) * K * row + lane;  // slot k at key[k row]
  uint32_t* wout = out + static_cast<size_t>(w) * K * 3 * L * row + lane;
  int32_t cur = k0 < K ? key[static_cast<size_t>(k0) * row] : 0;          // slot k's key
  int32_t prev = k0 > 0 && k0 < K ? key[static_cast<size_t>(k0 - 1) * row] : cur;
  bool open = k0 > 0 && cur == prev;  // the first run began in an earlier segment
  bool reset = false;
  int first_fix = -1;
  const Point<L> e = fold_slots<false>(
      in + static_cast<size_t>(w) * K * 2 * L * row, nullptr, k0, k1, lane, row,
      identity(c), c,
      [&](int k, int32_t, const Point<L>& acc) {
        const int32_t next = k + 1 < K ? key[static_cast<size_t>(k + 1) * row] : cur;
        if (k + 1 == K || next != cur) {  // a run end or the lane's last slot
          store_point<L>(wout + static_cast<size_t>(k) * 3 * L * row, row, acc);
          if (open) first_fix = k;
          open = false;
        }
        prev = cur;
        cur = next;
      },
      [&](int k) {
        const bool starts_run = k == 0 || cur != prev;
        reset = reset || starts_run;
        return starts_run || k == k0;
      });
  if (seg < S - 1) {
    store_point<L>(carries + static_cast<size_t>(seg) * 3 * L * pairs + t, pairs, e);
    resets[static_cast<size_t>(seg) * pairs + t] = reset ? 1 : 0;
  }
  if (seg > 0) fix[static_cast<size_t>(seg) * pairs + t] = first_fix;
}

// Pass 3: blockIdx.y + 1 is the segment.
template <int L>
__global__ void __launch_bounds__(kSplitThreads, 1)
fixup_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ carries,
             const int32_t* __restrict__ fix, int W, int K, int C, const CurveConsts<L> c) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * C) return;
  const size_t pairs = static_cast<size_t>(W) * C;
  const int seg = blockIdx.y + 1;
  const int k = fix[static_cast<size_t>(seg) * pairs + t];
  if (k < 0) return;
  const int w = t / C;
  const size_t row = static_cast<size_t>(C);
  uint32_t* p = out + (static_cast<size_t>(w) * K + k) * 3 * L * row + (t - w * C);
  const Point<L> carry =
      load_point<L>(carries + static_cast<size_t>(seg - 1) * 3 * L * pairs + t, pairs);
  store_point<L>(p, row, padd(carry, load_point<L>(p, row), c));
}

// The library's instance: build.py compiles this source once per limb
// count (libbucket_accum: 8, libbucket_accum_l12: 12,
// libbucket_accum_l24: 24), so that the instances compile in parallel.
#ifndef ICICLE_EC_LIMBS
#define ICICLE_EC_LIMBS 8
#endif

constexpr int kLimbs = ICICLE_EC_LIMBS;

}  // namespace

extern "C" {

// Launches passes 1-3 on `stream` without synchronising. keys, in, out,
// carries, resets, fix: device pointers, (W, K, C) int32, (W, K, 2L, C)
// and (W, K, 3L, C) uint32, then scratch unused when S = 1: (S - 1, 3L,
// W C) uint32, (S, W C) and (S, W C) int32. S: segments per lane, 1 <= S
// <= 65535. L must be the library's ICICLE_EC_LIMBS. consts: host array
// {p[L], one[L], inv32, b3}. Returns the first refused launch's
// cudaError_t (0 on success).
int icicle_msm_bucket_accum(const void* keys, const void* in, void* out, void* carries,
                            void* resets, void* fix, int W, int K, int C, int S, int L,
                            const unsigned int* consts, void* stream) {
  if (L != kLimbs || W < 1 || K < 1 || C < 1 || S < 1 || S > 65535 ||
      static_cast<long long>(W) * C > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto c = consts_from<kLimbs>(consts);
  auto* dst = static_cast<uint32_t*>(out);
  auto* car = static_cast<uint32_t*>(carries);
  auto* rst = static_cast<int32_t*>(resets);
  auto* fx = static_cast<int32_t*>(fix);
  const int pair_blocks = (W * C + kSplitThreads - 1) / kSplitThreads;
  accum_kernel<kLimbs><<<dim3(pair_blocks, S), kSplitThreads, 0, st>>>(
      static_cast<const int32_t*>(keys), static_cast<const uint32_t*>(in), dst, car, rst, fx, W,
      K, C, S, (K + S - 1) / S, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  err = launch_carry_scan(car, W * C, S, c, st, rst);
  if (err != cudaSuccess) return static_cast<int>(err);
  fixup_kernel<kLimbs><<<dim3(pair_blocks, S - 1), kSplitThreads, 0, st>>>(dst, car, fx, W, K,
                                                                          C, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
