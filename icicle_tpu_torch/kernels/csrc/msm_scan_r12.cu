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
// b3 = 9) and hard-codes bn254's schedules, `KERNEL_SCHEDULE` (the mixed
// add: no multiply needs an extra normalisation) and `PADD_SCHEDULE` (the
// projective add of the carry scan) in msm_scan_r12.py, both pinned by CPU
// tests against the audit.
//
// Design: one thread per lane over K = 8192 dependent adds (C = 4096
// lanes, 128 warps on 132 SMs) is latency-bound. So each lane's slots are
// split into S segments (msm_scan_r12.py r12_segments), segment s covering
// slots [s n, min(K, (s+1) n)), n = ceil(K / S), in three passes on one
// stream, as B3 (msm_scan.cu):
//   1. scan_reduce: one thread per (segment 0..S-2, lane) folds its slots
//      from the identity with madd_r12 and writes the segment's total, as
//      lazy words, to `carries` (S - 1, 3 NW, C) int32; segment 0's values
//      are final and written to out;
//   2. carry_scan: one thread per lane, carry_0 = identity and
//      carry_{s+1} = padd_r12(carry_s, total_s), in place (row s becomes
//      carry_{s+1});
//   3. rescan: one thread per (segment >= 1, lane) re-runs its madds from
//      carry_s (lazy words, as the serial state would be) and writes every
//      E_k.
// A warp takes 32 consecutive lanes of one segment, so each limb and word
// row is read and written 128 contiguous bytes at a time. Blocks are
// kSplitThreads; the state (3 NW words), the input (2 NW) and a multiply's
// 2 NW - 1 columns fill a thread's registers (ptxas: 255, the cap), so one
// block of 8 warps is resident an SM. The plain version
// (prefix_scan_r12_ref) repeats this association, so the two agree bit for
// bit; segment 0 and S = 1 give the serial fold's bits.
//
// Bound: the same mixed adds as B3, so the same bound (chip_smoke.py
// counts it as B3's); this engine's own count per slot is 11 radix-12
// multiplies of 2 NW^2 + NW = 990 32-bit multiplies each (NW^2 products,
// NW m's and NW^2 REDC products m p_j), against B3's 11 of 264, plus the
// two wordwise multiplies by b3 (2 NW). The split's extra adds (pass 3
// repeats about (S-1)/S of pass 1's, the carry scan S - 1 a lane) are not
// part of the bound.

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

// _padd_r12 (msm_scan_r12.py) line for line, with bn254's PADD_SCHEDULE:
// both points lazy (words <= 2 * 4095); the norms are the audit's, of the
// first operand of the three (a + b)(c + d) products, of t3 in t3 t1, of t4
// in z3 t4 and of t0 in t0 t3, and those after the multiplies by b3.
template <int NW>
__device__ __forceinline__ Point<NW> padd_r12(const Point<NW>& p, const Point<NW>& q,
                                              const R12Consts<NW>& c) {
  Words<NW> t0 = mul_mont<NW>(p.x, q.x, c);
  Words<NW> t1 = mul_mont<NW>(p.y, q.y, c);
  Words<NW> t2 = mul_mont<NW>(p.z, q.z, c);
  const Words<NW> t3 = sub<NW>(
      mul_mont<NW>(norm<NW>(add<NW>(p.x, p.y)), add<NW>(q.x, q.y), c), add<NW>(t0, t1));
  const Words<NW> t4 = sub<NW>(
      mul_mont<NW>(norm<NW>(add<NW>(p.y, p.z)), add<NW>(q.y, q.z), c), add<NW>(t1, t2));
  Words<NW> y3 = sub<NW>(
      mul_mont<NW>(norm<NW>(add<NW>(p.x, p.z)), add<NW>(q.x, q.z), c), add<NW>(t0, t2));
  t0 = add<NW>(add<NW>(t0, t0), t0);
  t2 = norm<NW>(mul_small<NW>(t2, c.b3));
  const Words<NW> z3 = add<NW>(t1, t2);
  t1 = sub<NW>(t1, t2);
  y3 = norm<NW>(mul_small<NW>(y3, c.b3));
  Point<NW> r;
  r.x = sub<NW>(mul_mont<NW>(norm<NW>(t3), t1, c), mul_mont<NW>(t4, y3, c));
  r.y = add<NW>(mul_mont<NW>(t1, z3, c), mul_mont<NW>(y3, t0, c));
  r.z = add<NW>(mul_mont<NW>(z3, norm<NW>(t4), c), mul_mont<NW>(norm<NW>(t0), t3, c));
  return r;
}

template <int NW>
__device__ __forceinline__ Point<NW> identity(const R12Consts<NW>& c) {
  Point<NW> e;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    e.x.w[k] = 0;
    e.y.w[k] = c.one[k];
    e.z.w[k] = 0;
  }
  return e;
}

// A point's lazy words in the carries' layout: word k of x / y / z at
// p[k * row], p[(NW + k) * row], p[(2 NW + k) * row].
template <int NW>
__device__ __forceinline__ Point<NW> load_words(const int32_t* p, size_t row) {
  Point<NW> e;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    e.x.w[k] = p[k * row];
    e.y.w[k] = p[(NW + k) * row];
    e.z.w[k] = p[(2 * NW + k) * row];
  }
  return e;
}

template <int NW>
__device__ __forceinline__ void store_words(int32_t* p, size_t row, const Point<NW>& e) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    p[k * row] = e.x.w[k];
    p[(NW + k) * row] = e.y.w[k];
    p[(2 * NW + k) * row] = e.z.w[k];
  }
}

template <int NW, int L>
__device__ __forceinline__ void store(const Words<NW>& v, uint32_t* dst, size_t row,
                                      const R12Consts<NW>& c) {
  uint32_t limbs[L];
  to_u32<NW, L>(norm<NW>(canon_nonneg<NW>(v, c)), limbs);
#pragma unroll
  for (int j = 0; j < L; ++j) dst[j * row] = limbs[j];
}

// E += slots [k0, k1) of one lane; each E_k written out where `write`.
template <int NW, int L>
__device__ __forceinline__ Point<NW> scan_slots(const uint32_t* __restrict__ in,
                                                uint32_t* __restrict__ out, int k0, int k1,
                                                int lane, size_t row, Point<NW> e, bool write,
                                                const R12Consts<NW>& c) {
  for (int k = k0; k < k1; ++k) {
    const uint32_t* src = in + static_cast<size_t>(k) * 2 * L * row + lane;
    uint32_t xl[L], yl[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      xl[j] = src[j * row];
      yl[j] = src[(L + j) * row];
    }
    e = madd_r12<NW>(e, from_u32<NW, L>(xl), from_u32<NW, L>(yl), c);
    if (write) {
      uint32_t* dst = out + static_cast<size_t>(k) * 3 * L * row + lane;
      store<NW, L>(e.x, dst, row, c);
      store<NW, L>(e.y, dst + L * row, row, c);
      store<NW, L>(e.z, dst + 2 * L * row, row, c);
    }
  }
  return e;
}

constexpr int kLaneThreads = 32;
// as B3's (ec_field.cuh kSplitThreads): one block an SM at 255 registers
constexpr int kSplitThreads = 256;

// Pass 1: blockIdx.y is the segment.
template <int NW, int L>
__global__ void __launch_bounds__(kSplitThreads, 1)
scan_reduce_r12_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                       int32_t* __restrict__ carries, int K, int C, int S, int n,
                       const R12Consts<NW> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  const int seg = blockIdx.y;
  const int k0 = min(K, seg * n);
  const int k1 = min(K, k0 + n);
  const Point<NW> e =
      scan_slots<NW, L>(in, out, k0, k1, lane, row, identity<NW>(c), seg == 0, c);
  if (seg < S - 1)
    store_words<NW>(carries + static_cast<size_t>(seg) * 3 * NW * row + lane, row, e);
}

// Pass 2: one thread per lane over the S - 1 totals.
template <int NW>
__global__ void __launch_bounds__(kLaneThreads)
carry_scan_r12_kernel(int32_t* __restrict__ carries, int C, int S, const R12Consts<NW> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  Point<NW> carry = identity<NW>(c);
  for (int s = 0; s < S - 1; ++s) {
    int32_t* p = carries + static_cast<size_t>(s) * 3 * NW * row + lane;
    carry = padd_r12<NW>(carry, load_words<NW>(p, row), c);
    store_words<NW>(p, row, carry);
  }
}

// Pass 3: blockIdx.y + 1 is the segment.
template <int NW, int L>
__global__ void __launch_bounds__(kSplitThreads, 1)
rescan_r12_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                  const int32_t* __restrict__ carries, int K, int C, int n,
                  const R12Consts<NW> c) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  const size_t row = static_cast<size_t>(C);
  const int seg = blockIdx.y + 1;
  const int k0 = min(K, seg * n);
  const int k1 = min(K, k0 + n);
  const Point<NW> carry =
      load_words<NW>(carries + static_cast<size_t>(seg - 1) * 3 * NW * row + lane, row);
  scan_slots<NW, L>(in, out, k0, k1, lane, row, carry, true, c);
}

}  // namespace

extern "C" {

// Launches the scan's passes on `stream` without synchronising. in, out,
// carries: device pointers, (K, 2L, C) and (K, 3L, C) uint32 and
// (S - 1, 3 * 22, C) int32 (scratch, unused when S = 1). S: segments per
// lane, 1 <= S <= 65535. consts: host array {p[22], 2p[22], R' mod p[22],
// inv12, b3} in 12-bit words. Only bn254 (NW = 22, L = 8) is built.
// Returns the first refused launch's cudaError_t (0 on success).
int icicle_msm_prefix_scan_r12(const void* in, void* out, void* carries, int K, int C, int S,
                               int L, const unsigned int* consts, void* stream) {
  if (L != 8 || K < 1 || C < 1 || S < 1 || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto c = consts_from<22>(consts);
  const auto* src = static_cast<const uint32_t*>(in);
  auto* dst = static_cast<uint32_t*>(out);
  auto* car = static_cast<int32_t*>(carries);
  const int n = (K + S - 1) / S;
  const int lane_blocks = (C + kSplitThreads - 1) / kSplitThreads;
  scan_reduce_r12_kernel<22, 8><<<dim3(lane_blocks, S > 1 ? S - 1 : 1), kSplitThreads, 0, st>>>(
      src, dst, car, K, C, S, n, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return static_cast<int>(err);
  carry_scan_r12_kernel<22><<<(C + kLaneThreads - 1) / kLaneThreads, kLaneThreads, 0, st>>>(
      car, C, S, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rescan_r12_kernel<22, 8><<<dim3(lane_blocks, S - 1), kSplitThreads, 0, st>>>(src, dst, car, K,
                                                                              C, n, c);
  return static_cast<int>(cudaGetLastError());
}

const char* icicle_msm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
