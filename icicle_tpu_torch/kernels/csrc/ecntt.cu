// The ECNTT's butterfly stage and scalar ladder on NVIDIA Hopper (sm_90a).
// Bound to Python with ctypes (icicle_tpu_torch/kernels/ecntt_kernel.py:
// ecntt_stage, ecntt_scale).
//
// Replaces no Pallas kernel: the JAX package runs the ECNTT in XLA,
//   icicle_tpu/ops/ecntt.py:35   scalar_mul_vec_glv (the GLV joint ladder),
//   icicle_tpu/ops/ecntt.py:87   scalar_mul_vec (the plain ladder),
//   icicle_tpu/ops/ecntt.py:220  _ecntt_core (the radix-2 DIT stages),
// and these kernels compute the same functions, point for point and
// coordinate for coordinate (the formulas are RCB15's complete adds and
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
// Design: one thread a butterfly (or a lane of the ladder), its ladder one
// serial chain of products; at bn254 2^16 a stage's 2^15 lanes are fewer
// than 8 warps an SM in one wave, so the chain's latency is exposed and
// parallelism inside a thread's work pays more than occupancy.
// - Arithmetic: ec_wide.cuh's (B3's wide instances', precompute_bases'): the
//   Montgomery multiply as PTX carry chains in two independent
//   accumulators (two products in flight a thread), values lazy in [0, 2p)
//   between the load and the store (no final subtraction after a product;
//   a sum reduced by 2p, a difference brought back by 2p), every stored
//   coordinate canonical, so the stored bits are the plain version's. The
//   launch refuses a modulus without two spare bits (4p < 2^(32 L):
//   bn254, grumpkin, bls12_377, bls12_381 and bw6_761 all have them). The
//   adds are ec_wide.cuh's padd (RCB15 Alg 7), the doublings its pdbl
//   (Alg 9), ec_field.cuh's add and dbl line for line; negating a lazy y
//   (0 - y, plus 2p on a borrow) keeps it in [0, 2p).
// - Tables: the two 16-entry tables are per-thread arrays indexed by the
//   data (the digits), so they live in local memory: 16 x 3 x L words
//   each, 1.5 KB at L = 8, 4.5 KB at 12, 9 KB at 24; the register file
//   could not hold even one. A thread reads one entry a table per digit
//   row (2 x 96 B at L = 8, against the row's 56 products). PERF.md has
//   this placement and block size timed against others.
// - One warp a block spreads the few lanes of the short stages (2^12 at
//   bls12_381 2^13, 128 at bw6_761 2^8) over the SMs.
// - Code size: up to 12 limbs the field multiply is called (ECNTT_MUL)
//   and the add and the doubling are inlined around its calls; at 24 the
//   add and the doubling are called (ECNTT_FORMULA) and the multiply,
//   whose outer loop is rolled, is inlined in them. With every formula
//   and multiply inlined the 8-limb stage kernel was 36,272 instructions
//   (the table build, the row loop and the butterfly held five formula
//   copies, each with its multiplies unrolled; 8,232 now), more than the
//   instruction caches hold: bn254's stage took 4.44-4.68 ms on the H100,
//   2.77-2.90 arranged as now; at 12 limbs the called multiply took
//   bls12_381's from 6.23 to 3.90 ms; at 24 it took bw6_761's from 20.9
//   to 26.1 ms, so there it stays inlined (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_wide.cuh"

#ifndef ICICLE_EC_LIMBS
#define ICICLE_EC_LIMBS 8
#endif

namespace {

using namespace icicle_ec;

constexpr int L = ICICLE_EC_LIMBS;
constexpr int kWdig = 4;
constexpr int kTable = 1 << kWdig;
constexpr int kThreads = 32;

// the lazy arithmetic's consts (p, 2p, R mod p, inv32, b3), a type of this
// file's own so that the formulas' products resolve to fmul below
struct K : wide::WideFp<L> {};
using F = Fp<L>;
using P = Point<L>;

// what is called and what inlined, by limb count: the header's "Code size"
#if ICICLE_EC_LIMBS <= 12
#define ECNTT_MUL __noinline__
#define ECNTT_FORMULA __forceinline__
#else
#define ECNTT_MUL __forceinline__
#define ECNTT_FORMULA __noinline__
#endif

__device__ ECNTT_MUL F fmul(const F& a, const F& b, const K& k) { return wide::mul<L>(a, b, k.f); }

__device__ ECNTT_FORMULA P add_pt(const P& a, const P& b, const K& k) {
  return wide::padd<K>(a, b, k);
}

__device__ ECNTT_FORMULA P dbl_pt(const P& a, const K& k) { return wide::pdbl<K>(a, k); }

// (x, -y, z): 0 - y in [0, 2p) for y in [0, 2p)
__device__ __forceinline__ P neg_pt(const P& a, const K& k) {
  return {a.x, wide::sub<L>(wide::fzero(k), a.y, k.f), a.z};
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

// Stores p's canonical coordinates.
__device__ __forceinline__ void store(uint32_t* x, uint32_t* y, uint32_t* z, size_t i,
                                      const P& p, const K& k) {
  const F cx = wide::canonical<L>(p.x, k.f), cy = wide::canonical<L>(p.y, k.f),
          cz = wide::canonical<L>(p.z, k.f);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    x[i * L + j] = cx.v[j];
    y[i * L + j] = cy.v[j];
    z[i * L + j] = cz.v[j];
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

__device__ __forceinline__ void build_table(P (&t)[kTable], const P& base, const K& k) {
  t[0] = wide::identity(k);
#pragma unroll 1
  for (int i = 1; i < kTable; ++i) t[i] = add_pt(t[i - 1], base, k);
}

// k_j P for the scalar of column j of the rows (JAX scalar_mul_vec_glv or
// scalar_mul_vec, step for step).
__device__ P ladder(const P& pt, int j, const Rows& r, const F& beta, const K& k) {
  P t1[kTable], t2[kTable];
  if (r.glv) {
    const P phi = {wide::mul<L>(pt.x, beta, k.f), pt.y, pt.z};
    build_table(t1, r.neg1[j] ? neg_pt(pt, k) : pt, k);
    build_table(t2, r.neg2[j] ? neg_pt(phi, k) : phi, k);
  } else {
    build_table(t1, pt, k);
  }
  P acc = wide::identity(k);
#pragma unroll 1
  for (int row = 0; row < r.ndig; ++row) {
#pragma unroll 1
    for (int d = 0; d < kWdig; ++d) acc = dbl_pt(acc, k);
    const size_t at = static_cast<size_t>(row) * r.stride + j;
    acc = add_pt(acc, t1[r.dig1[at]], k);
    if (r.glv) acc = add_pt(acc, t2[r.dig2[at]], k);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
stage_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
             const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
             uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int n, int m, int with_ladder,
             const Rows r, const F beta, const K k) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n / 2) return;
  const int j = lane & (m - 1);
  const size_t even = static_cast<size_t>(lane - j) * 2 + j;
  const size_t odd = even + m;
  P t = load(x, y, z, odd);
  if (with_ladder) t = ladder(t, j, r, beta, k);
  const P e = load(x, y, z, even);  // after the ladder: not live through it
  store(ox, oy, oz, even, add_pt(e, t, k), k);
  store(ox, oy, oz, odd, add_pt(e, neg_pt(t, k), k), k);
}

__global__ void __launch_bounds__(kThreads)
scale_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
             const uint32_t* __restrict__ z, uint32_t* __restrict__ ox,
             uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, int n, const Rows r,
             const F beta, const K k) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  store(ox, oy, oz, lane, ladder(load(x, y, z, lane), lane, r, beta, k), k);
}

// consts: {CurveConsts words (ec_field.cuh consts_from), beta[L] in
// Montgomery form}. False where the modulus lacks the lazy arithmetic's
// two spare bits.
bool read(const unsigned int* consts, K& k, F& beta) {
  k = K{wide::wide_consts(consts_from<L>(consts))};
  for (int j = 0; j < L; ++j) beta.v[j] = consts[2 * L + 2 + j];
  return wide::lazy_ok(k.f);
}

}  // namespace

extern "C" {

// One DIT stage (see the header) on `stream`, without synchronising. x, y,
// z: device pointers to (n, L) uint32; ox, oy, oz: (n, L) outputs, not
// aliasing the inputs; dig1, dig2: (ndig, m) int32, neg1, neg2: (m,)
// uint8 (dig2 and the flags read only with glv; nothing read without the
// ladder); n a multiple of 2m, m a power of two. L must be the library's
// ICICLE_EC_LIMBS. consts: host array {p[L], one[L], inv32, b3, beta[L]};
// p must have its top two bits clear. Returns the launch's cudaError_t (0
// on success).
int icicle_ecntt_stage(const void* x, const void* y, const void* z, void* ox, void* oy,
                       void* oz, const void* dig1, const void* dig2, const void* neg1,
                       const void* neg2, int n, int m, int with_ladder, int ndig, int glv,
                       int limbs, const unsigned int* consts, void* stream) {
  K k;
  F beta;
  if (limbs != L || n < 2 || m < 1 || (m & (m - 1)) != 0 || n % (2 * m) != 0 ||
      (with_ladder && ndig < 1) || !read(consts, k, beta))
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows r{static_cast<const int32_t*>(dig1), static_cast<const int32_t*>(dig2),
               static_cast<const uint8_t*>(neg1), static_cast<const uint8_t*>(neg2), ndig, m,
               glv};
  const int lanes = n / 2;
  stage_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const uint32_t*>(z), static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy),
      static_cast<uint32_t*>(oz), n, m, with_ladder, r, beta, k);
  return static_cast<int>(cudaGetLastError());
}

// The GLV ladder alone, lane j times the scalar of column j: the same
// arguments with stride == n (the rows' width), with_ladder == 1 and
// glv == 1 (the JAX package scales with GLV whatever its ladder switch).
int icicle_ecntt_scale(const void* x, const void* y, const void* z, void* ox, void* oy,
                       void* oz, const void* dig1, const void* dig2, const void* neg1,
                       const void* neg2, int n, int stride, int with_ladder, int ndig, int glv,
                       int limbs, const unsigned int* consts, void* stream) {
  K k;
  F beta;
  if (limbs != L || n < 1 || stride != n || with_ladder != 1 || glv != 1 || ndig < 1 ||
      !read(consts, k, beta))
    return static_cast<int>(cudaErrorInvalidValue);
  const Rows r{static_cast<const int32_t*>(dig1), static_cast<const int32_t*>(dig2),
               static_cast<const uint8_t*>(neg1), static_cast<const uint8_t*>(neg2), ndig, n,
               glv};
  scale_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const uint32_t*>(z), static_cast<uint32_t*>(ox), static_cast<uint32_t*>(oy),
      static_cast<uint32_t*>(oz), n, r, beta, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
