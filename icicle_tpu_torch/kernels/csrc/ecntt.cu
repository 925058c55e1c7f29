// The ECNTT's butterfly stage and scalar ladder on NVIDIA Hopper (sm_90a).
// Bound to Python with ctypes (icicle_tpu_torch/kernels/ecntt_kernel.py:
// ecntt_stage, ecntt_scale).
//
// Replaces no Pallas kernel: the JAX package runs the ECNTT in XLA,
//   icicle_tpu/ops/ecntt.py:35   scalar_mul_vec_glv (the GLV joint ladder),
//   icicle_tpu/ops/ecntt.py:87   scalar_mul_vec (the plain ladder),
//   icicle_tpu/ops/ecntt.py:220  _ecntt_core (the radix-2 DIT stages),
// and these kernels compute the same functions, point for point and
// coordinate for coordinate (the formulas are ec_field.cuh's RCB15 adds and
// doublings, the plain versions' line for line, applied in the same order):
//   stage  one DIT stage of half-block m over n points: lane l < n / 2,
//          block b = l / m, j = l % m, reads even = point b 2m + j and
//          odd = point b 2m + m + j, t = w_j odd (the ladder over the
//          stage's digit rows at column j; t = odd when `ladder` is 0, stage
//          1), and writes even + t and even - t (a complete add of -t);
//   scale  lane j < n: out_j = k_j P_j (the GLV ladder over column j).
// Points: x, y, z (n, L) uint32 Montgomery-form coordinates, a point's L
// limbs contiguous (the port's Projective tensors); outputs the same shape
// in separate buffers. Ladder (2^4-ary, digit rows (ndig, stride) int32,
// most significant first): with GLV, a table of i P' and one of
// i phi(P)' (P' = +-P, phi(P)' = +-(beta x, y, z) by the sign flags), each
// entry i = entry i-1 + base from the identity; per digit row four
// doublings and two table adds. Without, one table of i P and one add.
//
// Bound: operations. A GLV ladder at bn254 (33 digit rows) is 30 table
// adds, 132 doublings and 66 adds: 30 12 + 132 8 + 66 12 = 2,208
// Montgomery multiplies (b3 is an add chain), each 4 L^2 + L 32-bit
// multiplies; a forward 2^16 has 15 ladder stages of 2^15 lanes
// (chip_smoke.py ecntt_bound counts every launch from its digit rows).
//
// Design: one thread a butterfly (or a lane of the ladder). The two
// 16-entry tables are per-thread arrays indexed by the data (the digits),
// so they live in local memory: 16 x 3 x L words each, 1.5 KB at L = 8,
// 4.5 KB at 12, 9 KB at 24; the register file could not hold even one.
// Local memory is cached in L1 and L2, and a thread reads one entry per
// digit row. One warp a block spreads the few lanes of the short stages
// (2^12 at bls12_381 2^13, 128 at bw6_761 2^8) over the SMs. At L = 12 and
// 24 the add and the doubling are called, not inlined: inlined, the 12-limb
// library compiled for 137 s alone on the H100 machine (its CIOS loop
// unrolled in each of a dozen formula sites), the 8-limb one for 70 s.

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

#ifndef ICICLE_EC_LIMBS
#define ICICLE_EC_LIMBS 8
#endif

namespace {

using namespace icicle_ec;

constexpr int L = ICICLE_EC_LIMBS;
constexpr int kWdig = 4;
constexpr int kTable = 1 << kWdig;
constexpr int kThreads = 32;

using C = CurveConsts<L>;
using F = Fp<L>;
using P = Point<L>;

#if ICICLE_EC_LIMBS >= 12
#define ECNTT_FORMULA __noinline__
#else
#define ECNTT_FORMULA __forceinline__
#endif

__device__ ECNTT_FORMULA P add_pt(const P& a, const P& b, const C& c) { return padd<C>(a, b, c); }

__device__ ECNTT_FORMULA P dbl_pt(const P& a, const C& c) { return dbl<C>(a, c); }

__device__ __forceinline__ P neg_pt(const P& a, const C& c) {
  return {a.x, sub_mod<L>(f_zero<L>(c), a.y, c), a.z};
}

__device__ __forceinline__ P load(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                                  size_t i) {
  P p;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    p.x.v[j] = x[i * L + j];
    p.y.v[j] = y[i * L + j];
    p.z.v[j] = z[i * L + j];
  }
  return p;
}

__device__ __forceinline__ void store(uint32_t* x, uint32_t* y, uint32_t* z, size_t i,
                                      const P& p) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    x[i * L + j] = p.x.v[j];
    y[i * L + j] = p.y.v[j];
    z[i * L + j] = p.z.v[j];
  }
}

// The digit rows of one launch: (ndig, stride) int32 digits and (stride,)
// uint8 sign flags (dig2 and the flags with GLV only).
struct Rows {
  const int32_t* dig1;
  const int32_t* dig2;
  const uint8_t* neg1;
  const uint8_t* neg2;
  int ndig;
  int stride;
  int glv;
};

__device__ __forceinline__ void build_table(P (&t)[kTable], const P& base, const C& c) {
  t[0] = identity<C>(c);
#pragma unroll 1
  for (int i = 1; i < kTable; ++i) t[i] = add_pt(t[i - 1], base, c);
}

// k_j P for the scalar of column j of the rows (JAX scalar_mul_vec_glv or
// scalar_mul_vec, step for step).
__device__ P ladder(const P& pt, int j, const Rows& r, const F& beta, const C& c) {
  P t1[kTable], t2[kTable];
  if (r.glv) {
    const P phi = {mont_mul<L>(pt.x, beta, c), pt.y, pt.z};
    build_table(t1, r.neg1[j] ? neg_pt(pt, c) : pt, c);
    build_table(t2, r.neg2[j] ? neg_pt(phi, c) : phi, c);
  } else {
    build_table(t1, pt, c);
  }
  P acc = identity<C>(c);
#pragma unroll 1
  for (int row = 0; row < r.ndig; ++row) {
#pragma unroll 1
    for (int k = 0; k < kWdig; ++k) acc = dbl_pt(acc, c);
    const size_t at = static_cast<size_t>(row) * r.stride + j;
    acc = add_pt(acc, t1[r.dig1[at]], c);
    if (r.glv) acc = add_pt(acc, t2[r.dig2[at]], c);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
stage_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
             const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
             uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int n, int m, int with_ladder,
             const Rows r, const F beta, const C c) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n / 2) return;
  const int j = lane & (m - 1);
  const size_t even = static_cast<size_t>(lane - j) * 2 + j;
  const size_t odd = even + m;
  const P e = load(x, y, z, even);
  P t = load(x, y, z, odd);
  if (with_ladder) t = ladder(t, j, r, beta, c);
  store(ox, oy, oz, even, add_pt(e, t, c));
  store(ox, oy, oz, odd, add_pt(e, neg_pt(t, c), c));
}

__global__ void __launch_bounds__(kThreads)
scale_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
             const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
             uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int n, const Rows r,
             const F beta, const C c) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  store(ox, oy, oz, lane, ladder(load(x, y, z, lane), lane, r, beta, c));
}

// consts: {CurveConsts words (ec_field.cuh consts_from), beta[L] in
// Montgomery form}.
void read(const unsigned int* consts, C& c, F& beta) {
  c = consts_from<L>(consts);
  for (int j = 0; j < L; ++j) beta.v[j] = consts[2 * L + 2 + j];
}

}  // namespace

extern "C" {

// One DIT stage (see the header) on `stream`, without synchronising. x, y,
// z: device pointers to (n, L) uint32; ox, oy, oz: (n, L) outputs, not
// aliasing the inputs; dig1, dig2: (ndig, m) int32, neg1, neg2: (m,)
// uint8 (dig2 and the flags read only with glv; nothing read without the
// ladder); n a multiple of 2m, m a power of two. L must be the library's
// ICICLE_EC_LIMBS. consts: host array {p[L], one[L], inv32, b3, beta[L]}.
// Returns the launch's cudaError_t (0 on success).
int icicle_ecntt_stage(const void* x, const void* y, const void* z, void* ox, void* oy,
                       void* oz, const void* dig1, const void* dig2, const void* neg1,
                       const void* neg2, int n, int m, int with_ladder, int ndig, int glv,
                       int limbs, const unsigned int* consts, void* stream) {
  if (limbs != L || n < 2 || m < 1 || (m & (m - 1)) != 0 || n % (2 * m) != 0 ||
      (with_ladder && ndig < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  C c;
  F beta;
  read(consts, c, beta);
  const Rows r{static_cast<const int32_t*>(dig1), static_cast<const int32_t*>(dig2),
               static_cast<const uint8_t*>(neg1), static_cast<const uint8_t*>(neg2), ndig, m,
               glv};
  const int lanes = n / 2;
  stage_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const uint32_t*>(z), static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy),
      static_cast<uint32_t*>(oz), n, m, with_ladder, r, beta, c);
  return static_cast<int>(cudaGetLastError());
}

// The GLV ladder alone, lane j times the scalar of column j: the same
// arguments with stride == n (the rows' width), with_ladder == 1 and
// glv == 1 (the JAX package scales with GLV whatever its ladder switch).
int icicle_ecntt_scale(const void* x, const void* y, const void* z, void* ox, void* oy,
                       void* oz, const void* dig1, const void* dig2, const void* neg1,
                       const void* neg2, int n, int stride, int with_ladder, int ndig, int glv,
                       int limbs, const unsigned int* consts, void* stream) {
  if (limbs != L || n < 1 || stride != n || with_ladder != 1 || glv != 1 || ndig < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  C c;
  F beta;
  read(consts, c, beta);
  const Rows r{static_cast<const int32_t*>(dig1), static_cast<const int32_t*>(dig2),
               static_cast<const uint8_t*>(neg1), static_cast<const uint8_t*>(neg2), ndig, n,
               glv};
  scale_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const uint32_t*>(z), static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy),
      static_cast<uint32_t*>(oz), n, r, beta, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
