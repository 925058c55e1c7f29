// MSM v2 suffix fold on NVIDIA Hopper (sm_90a). Bound to Python with ctypes
// (icicle_tpu_torch/kernels/msm_fold2.py: suffix_fold).
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
//   out   (3L, C) uint32: D, x / y / z rows.
// The Pallas kernel takes bf16 coordinate bytes (its matrix-unit permute's
// output) in an (n_groups, K, 8L + 8, G) layout; here the limbs come as
// int32 from a gather and the lane groups are folded into C.
//
// Design: one thread per lane, E and D (6L words) in registers for all K
// slots. Each accumulator is updated under a branch on its flag bit, so a
// lane computes an add only where its flag keeps it. The Pallas body
// computes both adds every slot and selects; the kept values are the same
// limbs, so the two agree bit for bit.
//
// Bound: per slot a mixed add (11 Montgomery multiplies of 4L^2 + L 32-bit
// multiplies) and a projective add (12), as the Pallas body computes, the
// multiplies by b3 being add chains; against (2L + 1) * 4 bytes read per
// slot. The multiplies bound it; the kernel is latency-bound far above
// that, as B3 (K = T + 2^(c-1) dependent slots per thread).

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

namespace {

using namespace icicle_ec;

template <int L>
__global__ void __launch_bounds__(kLaneThreads)
suffix_fold_kernel(const uint32_t* __restrict__ in, const int32_t* __restrict__ flags,
                   uint32_t* __restrict__ out, int K, int C, const CurveConsts<L> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  Point<L> e = identity<L>(c);
  Point<L> d = identity<L>(c);
  for (int k = 0; k < K; ++k) {
    const int32_t fl = flags[static_cast<size_t>(k) * row + lane];
    if (fl & 1) {
      const uint32_t* src = in + static_cast<size_t>(k) * 2 * L * row + lane;
      Fp<L> x, y;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        x.v[j] = src[j * row];
        y.v[j] = src[(L + j) * row];
      }
      e = madd<L>(e, x, y, c);
    }
    if (fl & 2) d = padd<L>(d, e, c);
  }
  uint32_t* dst = out + lane;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    dst[j * row] = d.x.v[j];
    dst[(L + j) * row] = d.y.v[j];
    dst[(2 * L + j) * row] = d.z.v[j];
  }
}

}  // namespace

extern "C" {

// Launches the fold on `stream` without synchronising. in, flags, out:
// device pointers, (K, 2L, C) uint32, (K, C) int32 and (3L, C) uint32.
// consts: host array {p[L], one[L], inv32, b3}. Only L = 8 is built.
// Returns the launch's cudaError_t (0 on success).
int icicle_msm_suffix_fold(const void* in, const void* flags, void* out, int K, int C,
                           int L, const unsigned int* consts, void* stream) {
  if (L != 8 || K < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (C + kLaneThreads - 1) / kLaneThreads;
  suffix_fold_kernel<8><<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<const int32_t*>(flags),
      static_cast<uint32_t*>(out), K, C, consts_from<8>(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
