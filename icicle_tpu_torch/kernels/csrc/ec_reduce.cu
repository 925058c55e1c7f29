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
// Bound: per row 12 Montgomery multiplies of 4L^2 + L 32-bit multiplies
// each (the two by b3 are add chains) against 3L * 4 bytes read; at L = 8
// the multiplies bound it (chip_smoke.py computes both from each run's
// shapes). The tree's S - 1 extra adds per lane are not part of the bound.
//
// Design: one thread per lane would run R dependent adds on C threads (at
// the MSM's cross-tile shape R 2048 on 2048 threads: half the SMs idle, the
// rest latency-bound). So each lane's rows are split into S segments
// (ec_reduce.py reduce_segments: the smallest power of two with S * C >=
// 2^16 threads, at most R and 32). A block of kSplitThreads holds G =
// 256 / S lanes x S segments; thread (s, g) folds rows [s * n, min(R,
// (s+1) n)), n = ceil(R / S), from the identity (an empty segment gives
// the identity), then the S partials combine in a fixed pairwise tree
// through shared memory: while S > 1, partial[s] = padd(partial[s],
// partial[s + S/2]) for s < S/2, and S halves. Each partial stays in its
// thread's registers; only the upper half of each level goes through
// shared memory. A warp covers G >= 8 lanes of 32 / G segments, so each
// limb row is read in whole 32-byte sectors. The plain version
// (ec_reduce_ref) repeats this association, so the two agree bit for bit;
// S = 1 is the serial fold.

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

namespace {

using namespace icicle_ec;

template <int L>
__global__ void __launch_bounds__(kSplitThreads, 1)
ec_reduce_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int R, int C, int S, int n, const CurveConsts<L> c) {
  // per segment 3L words x G lanes, plus G words of padding so that the
  // 32 / G segments of one warp fall in distinct banks
  __shared__ uint32_t part[kSplitThreads * (3 * L + 1)];
  const int G = kSplitThreads / S;
  const int g = threadIdx.x % G;
  const int seg = threadIdx.x / G;
  const int lane = blockIdx.x * G + g;
  const bool live = lane < C;
  const size_t row = static_cast<size_t>(C);
  Point<L> acc = identity<L>(c);
  if (live) {
    const int r1 = min(R, (seg + 1) * n);
    for (int r = seg * n; r < r1; ++r)
      acc = padd<L>(acc, load_point<L>(in + static_cast<size_t>(r) * 3 * L * row + lane, row), c);
  }
  const size_t slot = static_cast<size_t>(G) * (3 * L + 1);
  for (int h = S / 2; h >= 1; h /= 2) {
    // segments [h, 2h) hand their partials to [0, h); the next level's
    // writers [h/2, h) write slots this level does not read
    if (seg >= h && seg < 2 * h) store_point<L>(part + seg * slot + g, G, acc);
    __syncthreads();
    if (seg < h) acc = padd<L>(acc, load_point<L>(part + (seg + h) * slot + g, G), c);
  }
  if (seg == 0 && live) store_point<L>(out + lane, row, acc);
}

}  // namespace

extern "C" {

// Launches the reduction on `stream` without synchronising. in, out: device
// pointers, (R, 3L, C) and (3L, C) uint32. S: segments per lane, a power of
// two <= 32. consts: host array {p[L], one[L], inv32, b3}. Only L = 8 is
// built. Returns the launch's cudaError_t (0 on success).
int icicle_msm_ec_reduce(const void* in, void* out, int R, int C, int S, int L,
                         const unsigned int* consts, void* stream) {
  if (L != 8 || R < 1 || C < 1 || S < 1 || S > 32 || (S & (S - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = kSplitThreads / S;
  const int n = (R + S - 1) / S;
  ec_reduce_kernel<8><<<(C + G - 1) / G, kSplitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), R, C, S, n,
      consts_from<8>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
