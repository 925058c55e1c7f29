// MSM v3 prefix scan (the E-stream) on the signed radix-2^12 engine, for
// NVIDIA Hopper (sm_90a). Bound to Python with ctypes
// (icicle_tpu_torch/kernels/msm_scan_r12.py: prefix_scan_r12).
//
// Replaces the TPU kernel
//   B5  icicle_tpu/pallas/msm_scan_r12.py:135  make_prefix_scan_r12
// computing the same function: per lane, E_0 = identity (0, 1, 0) and
// E_k = E_{k-1} + P_k by the complete mixed add (RCB15 Alg 8, a = 0) over
// radix12.cuh, with every E_k written out.
//   in  (K, 2L, C) uint32: slot k's point, R' = 2^(12 NW) Montgomery form,
//       x in rows 0..L-1, y (already negated where the digit is) in rows
//       L..2L-1;
//   out (K, 3L, C) uint32: E_k, x / y / z rows, each to_u32(norm(
//       canon_nonneg(v))), a value in [0, 4p) in the R' domain.
// The outputs are not canonical, so this must repeat the plain version's
// exact sequence of operations: the E state stays lazy between slots
// (words up to 2 * 4095) and is never normalised, and each multiply
// normalises an operand only where the torch side's overflow audit does.
// The audit decides from static bounds, so per field it is a fixed
// schedule; this file is instantiated for bn254 only (NW = 22, L = 8,
// b3 = 9) and hard-codes bn254's schedule, which is `KERNEL_SCHEDULE` in
// msm_scan_r12.py (pinned by a CPU test against the JAX package's
// `_R12Field`): no multiply needs an extra normalisation there.
//
// Design: as B3, one thread per lane, the E state (3 NW words) in
// registers for all K slots; each slot reads 2L words and writes 3L,
// lane-minor, so a warp's reads and writes coalesce.
//
// Bound: the same mixed adds as B3, so the same bound (chip_smoke.py
// counts it as B3's); this engine's own count per slot is 11 radix-12
// multiplies of 2 NW^2 + NW = 990 32-bit multiplies each (NW^2 products,
// NW m's and NW^2 REDC products m p_j), against B3's 11 of 264, plus the
// two wordwise multiplies by b3 (2 NW). It is far from either at the
// MSM's shapes, for B3's reason: K = 8192 dependent adds per thread over
// C = 4096 threads. Its 3 NW state words, 2 NW input words and
// 2 NW - 1 columns fill a thread's register file: ptxas reports 255
// registers (the cap), 0 bytes of stack and no spills.

#include <cstdint>
#include <cuda_runtime.h>

#include "radix12.cuh"

namespace {

using namespace icicle_r12;

template <int NW>
struct Point {
  Words<NW> x, y, z;
};

// _madd_r12 (msm_scan_r12.py) line for line, with bn254's schedule: the
// normalisations are those the function writes, none inside a multiply.
template <int NW>
__device__ __forceinline__ Point<NW> madd_r12(const Point<NW>& e, const Words<NW>& x2,
                                              const Words<NW>& y2, const R12Consts<NW>& c) {
  Words<NW> t0 = mul_mont<NW>(e.x, x2, c);
  Words<NW> t1 = mul_mont<NW>(e.y, y2, c);
  Words<NW> t3 = sub<NW>(mul_mont<NW>(norm<NW>(add<NW>(e.x, e.y)), add<NW>(x2, y2), c),
                         add<NW>(t0, t1));
  Words<NW> t4 = add<NW>(mul_mont<NW>(y2, e.z, c), e.y);
  Words<NW> y3 = add<NW>(mul_mont<NW>(x2, e.z, c), e.x);
  t0 = add<NW>(add<NW>(t0, t0), t0);
  const Words<NW> t2 = norm<NW>(mul_small<NW>(e.z, c.b3));
  Words<NW> z3 = add<NW>(t1, t2);
  t1 = sub<NW>(t1, t2);
  y3 = norm<NW>(mul_small<NW>(y3, c.b3));
  t3 = norm<NW>(t3);
  t4 = norm<NW>(t4);
  Point<NW> r;
  r.x = sub<NW>(mul_mont<NW>(t3, t1, c), mul_mont<NW>(t4, y3, c));
  r.y = add<NW>(mul_mont<NW>(t1, z3, c), mul_mont<NW>(y3, t0, c));
  r.z = add<NW>(mul_mont<NW>(z3, t4, c), mul_mont<NW>(t0, t3, c));
  return r;
}

template <int NW, int L>
__device__ __forceinline__ void store(const Words<NW>& v, uint32_t* dst, size_t row,
                                      const R12Consts<NW>& c) {
  uint32_t limbs[L];
  to_u32<NW, L>(norm<NW>(canon_nonneg<NW>(v, c)), limbs);
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j * row] = limbs[j];
}

constexpr int kLaneThreads = 32;

template <int NW, int L>
__global__ void __launch_bounds__(kLaneThreads)
prefix_scan_r12_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                       int K, int C, const R12Consts<NW> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  Point<NW> e;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    e.x.w[k] = 0;
    e.y.w[k] = c.one[k];
    e.z.w[k] = 0;
  }
  for (int k = 0; k < K; ++k) {
    const uint32_t* src = in + static_cast<size_t>(k) * 2 * L * row + lane;
    uint32_t xl[L], yl[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      xl[j] = src[j * row];
      yl[j] = src[(L + j) * row];
    }
    e = madd_r12<NW>(e, from_u32<NW, L>(xl), from_u32<NW, L>(yl), c);
    uint32_t* dst = out + static_cast<size_t>(k) * 3 * L * row + lane;
    store<NW, L>(e.x, dst, row, c);
    store<NW, L>(e.y, dst + L * row, row, c);
    store<NW, L>(e.z, dst + 2 * L * row, row, c);
  }
}

}  // namespace

extern "C" {

// Launches the scan on `stream` without synchronising. in, out: device
// pointers, (K, 2L, C) and (K, 3L, C) uint32. consts: host array
// {p[22], 2p[22], R' mod p[22], inv12, b3} in 12-bit words. Only bn254
// (NW = 22, L = 8) is built. Returns the launch's cudaError_t (0 on
// success).
int icicle_msm_prefix_scan_r12(const void* in, void* out, int K, int C, int L,
                               const unsigned int* consts, void* stream) {
  if (L != 8 || K < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (C + kLaneThreads - 1) / kLaneThreads;
  prefix_scan_r12_kernel<22, 8><<<blocks, kLaneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), K, C,
      consts_from<22>(consts));
  return static_cast<int>(cudaGetLastError());
}

const char* icicle_msm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
