// Lane-parallel sum of projective EC points on NVIDIA Hopper (sm_90a).
// Bound to Python with ctypes (icicle_tpu_torch/kernels/ec_reduce.py:
// ec_reduce).
//
// Replaces the TPU kernel
//   B4  icicle_tpu/pallas/ec_reduce.py:63  make_ec_reduce
// computing the same function: per lane, the sum over R rows by the
// complete projective add (RCB15 Alg 7, a = 0), starting from the identity
// (0, 1, 0) as the Pallas kernel does (ec_reduce.py:106-111).
//   in  (R, 3W, C) uint32 projective Montgomery points, x / y / z in rows
//       0..W-1 / W..2W-1 / 2W..3W-1, W words a coordinate (L over Fp, 2L
//       over Fp2);
//   out (3W, C) uint32.
// The Pallas kernel pads C to 128 lanes and R to a multiple of its VMEM
// row block with identity points; neither is needed here (each added
// identity would scale the projective coordinates by Y).
//
// Bound: per row 12 Montgomery multiplies of 4L^2 + L 32-bit multiplies
// each (the two by b3 are add chains) against 3L * 4 bytes read (over
// Fp2: 12 Fp2 products of three, plus two by a general b3, against 6L * 4
// bytes); at every L the multiplies bound it (chip_smoke.py computes both
// from each run's shapes). The tree's S - 1 extra adds per lane are not
// part of the bound.
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
//
// That is the 8-limb G1 instance (bn254, grumpkin), over ec_field.cuh. The
// instances of 12 or more words a coordinate (bls12_377 / bls12_381 G1 at
// 12 limbs, bw6_761 G1 and G2 at 24, bn254 G2 over Fp2<8>, bls12_377 /
// bls12_381 G2 over Fp2<12>) run the same split and tree over ec_wide.cuh
// (wide_ec_reduce_kernel below, as msm_scan.cu's wide passes): carry-chain
// multiplies, values lazy in [0, 2p) along a segment and through the tree
// (the partials pass through shared memory lazy), only the store to `out`
// canonical, and a padd that loads the row a coordinate at a time
// (ec_wide.cuh padd_row). Their blocks are kWideSplitThreads (128), two an
// SM, as B3's wide passes: ptxas's cap stays 255 registers, and the tree's
// partials take 128 (3W + 1) words (37,376 bytes at W = 24), so two blocks
// fit an SM's shared memory with no opt-in. A block then holds 128 / S
// lanes: at S = 32 a warp reads 16 bytes of a limb row a segment, half a
// sector (PERF.md has the times of the other shapes tried).

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

// The library's instance: build.py compiles this source once per (limb
// count, degree) (libec_reduce: 8, libec_reduce_l12: 12, libec_reduce_l24:
// 24 over Fp; libec_reduce_fp2: 8, libec_reduce_fp2_l12: 12 over Fp2). The
// instances of 12 or more words a coordinate (all but the 8-limb G1 one)
// take ec_wide.cuh's arithmetic (ICICLE_EC_WIDE).
#ifndef ICICLE_EC_LIMBS
#define ICICLE_EC_LIMBS 8
#endif
#ifndef ICICLE_EC_DEGREE
#define ICICLE_EC_DEGREE 1
#endif
#if ICICLE_EC_LIMBS * ICICLE_EC_DEGREE >= 12
#define ICICLE_EC_WIDE 1
#include "ec_wide.cuh"
#else
#define ICICLE_EC_WIDE 0
#endif

namespace {

using namespace icicle_ec;

// C: CurveConsts<L> (Fp<L>) or Fp2Consts<L> (Fp2<L>); W words a coordinate.
template <class C>
__global__ void __launch_bounds__(kSplitThreads, 1)
ec_reduce_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 int R, int lanes, int S, int n, const C c) {
  using F = Coord<C>;
  constexpr int W = F::kWords;
  // per segment 3W words x G lanes, plus G words of padding so that the
  // 32 / G segments of one warp fall in distinct banks:
  // part_bytes<W>(kSplitThreads) of dynamic shared memory (74,752 bytes at W = 24, over the 48 KB that
  // static shared memory may take)
  extern __shared__ uint32_t part[];
  const int G = kSplitThreads / S;
  const int g = threadIdx.x % G;
  const int seg = threadIdx.x / G;
  const int lane = blockIdx.x * G + g;
  const bool live = lane < lanes;
  const size_t row = static_cast<size_t>(lanes);
  ECPoint<F> acc = identity(c);
  if (live) {
    const int r1 = min(R, (seg + 1) * n);
    for (int r = seg * n; r < r1; ++r)
      acc = padd(acc, load_pt<F>(in + static_cast<size_t>(r) * 3 * W * row + lane, row), c);
  }
  const size_t slot = static_cast<size_t>(G) * (3 * W + 1);
  for (int h = S / 2; h >= 1; h /= 2) {
    // segments [h, 2h) hand their partials to [0, h); the next level's
    // writers [h/2, h) write slots this level does not read
    if (seg >= h && seg < 2 * h) store_pt<F>(part + seg * slot + g, G, acc);
    __syncthreads();
    if (seg < h) acc = padd(acc, load_pt<F>(part + (seg + h) * slot + g, G), c);
  }
  if (seg == 0 && live) store_pt<F>(out + lane, row, acc);
}

#if ICICLE_EC_WIDE
// The wide instances' kernel: the same split, tree and adds in the same
// order, over ec_wide.cuh (Q: its WideFp / WideFp2 consts), in blocks of
// kWideSplitThreads.
template <class Q>
__global__ void __launch_bounds__(wide::kWideSplitThreads, wide::kWideBlocksPerSM)
wide_ec_reduce_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int R,
                      int lanes, int S, int n, const Q q) {
  using F = typename Q::F;
  constexpr int W = F::kWords;
  extern __shared__ uint32_t part[];   // part_bytes<W>(kWideSplitThreads)
  const int G = wide::kWideSplitThreads / S;
  const int g = threadIdx.x % G;
  const int seg = threadIdx.x / G;
  const int lane = blockIdx.x * G + g;
  const bool live = lane < lanes;
  const size_t row = static_cast<size_t>(lanes);
  ECPoint<F> acc = wide::identity(q);
  if (live) {
    const int r1 = min(R, (seg + 1) * n);
    for (int r = seg * n; r < r1; ++r)
      acc = wide::padd_row(acc, in + static_cast<size_t>(r) * 3 * W * row + lane, row, q);
  }
  const size_t slot = static_cast<size_t>(G) * (3 * W + 1);
  for (int h = S / 2; h >= 1; h /= 2) {
    if (seg >= h && seg < 2 * h) store_pt<F>(part + seg * slot + g, G, acc);
    __syncthreads();
    if (seg < h) acc = wide::padd_row(acc, part + (seg + h) * slot + g, G, q);
  }
  if (seg == 0 && live) wide::store_canonical(out + lane, row, acc, q);
}
#endif

// Dynamic shared memory of a block of `threads`: per segment 3W words x G
// lanes plus G words of padding.
template <int W>
constexpr size_t part_bytes(int threads) {
  return sizeof(uint32_t) * threads * (3 * W + 1);
}

#if ICICLE_EC_DEGREE == 2
using Consts = icicle_ec::Fp2Consts<ICICLE_EC_LIMBS>;
#else
using Consts = icicle_ec::CurveConsts<ICICLE_EC_LIMBS>;
#endif

// Launches `kernel` over blocks of `threads`, G = threads / S lanes a
// block, with its partials' shared memory; above 48 KB a kernel takes
// dynamic shared memory only after cudaFuncSetAttribute, on each device it
// runs on.
template <int W, class Kernel, class K>
int launch_tree(Kernel kernel, int threads, const void* in, void* out, int R, int lanes, int S,
                const K& k, cudaStream_t st) {
  const size_t bytes = part_bytes<W>(threads);
  if (bytes > 48 * 1024) {
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const int G = threads / S;
  const int n = (R + S - 1) / S;
  kernel<<<(lanes + G - 1) / G, threads, bytes, st>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), R, lanes, S, n, k);
  return static_cast<int>(cudaGetLastError());
}

int launch_reduce(const void* in, void* out, int R, int lanes, int S,
                  const unsigned int* consts, cudaStream_t st) {
  Consts c;
  read_consts(consts, c);
  constexpr int W = icicle_ec::Coord<Consts>::kWords;
#if ICICLE_EC_WIDE
  using Q = decltype(wide::wide_consts(c));
  const Q q = wide::wide_consts(c);
  if (!wide::lazy_ok(q.f)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_tree<W>(wide_ec_reduce_kernel<Q>, wide::kWideSplitThreads, in, out, R, lanes, S,
                        q, st);
#else
  return launch_tree<W>(ec_reduce_kernel<Consts>, kSplitThreads, in, out, R, lanes, S, c, st);
#endif
}

}  // namespace

extern "C" {

// Launches the reduction on `stream` without synchronising. in, out: device
// pointers, (R, 3W, C) and (3W, C) uint32, W = D L words a coordinate. S:
// segments per lane, a power of two <= 32. L, D: the base field's limbs
// and the coordinate field's degree over it, which must be the library's
// ICICLE_EC_LIMBS and ICICLE_EC_DEGREE. consts: as icicle_msm_prefix_scan's.
// Returns the launch's cudaError_t (0 on success).
int icicle_msm_ec_reduce(const void* in, void* out, int R, int C, int S, int L, int D,
                         const unsigned int* consts, void* stream) {
  if (R < 1 || C < 1 || S < 1 || S > 32 || (S & (S - 1)) || L != ICICLE_EC_LIMBS ||
      D != ICICLE_EC_DEGREE)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_reduce(in, out, R, C, S, consts, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
