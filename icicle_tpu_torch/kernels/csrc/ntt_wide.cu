// Fused radix-2 DIF pass over the rows of a matrix of field elements wider
// than one word, for NVIDIA Hopper (sm_90a): goldilocks (one uint64 an
// element), the 8-limb fields below 2^255 and the 12-limb fields with two
// spare bits (bw6_761_scalar = bls12_377_base, bls12_381_base), over
// ec_wide.cuh's carry-chain Montgomery arithmetic. Bound to Python with
// ctypes (icicle_tpu_torch/kernels/ntt_wide.py: dif_rows_wide). Built twice:
// libntt_wide (ICICLE_EC_LIMBS 8: the Gl64 and Fp<8> instances) and
// libntt_wide_l12 (ICICLE_EC_LIMBS 12: Fp<12>), so the two compile in
// parallel.
//
// No TPU kernel is replaced: the JAX package computes the NTT of a limb
// field as XLA (icicle_tpu/ops/ntt.py:223-329, `_ntt_four_step` and
// `_ntt_vecfirst`), since its Pallas kernels take single-word fields only
// (ntt.py:342-344). The function is that of ntt_dif.cu's `dif_rows`: row r
// of length N = 2^log_n goes through all log_n DIF stages (times `factor`
// on load when given), natural order in, bit-reversed order out. Stage s,
// half-block m = N >> (s+1), butterfly on (i0, i1 = i0 + m), k = i0 mod m:
//   y[i0] = x[i0] + x[i1]
//   y[i1] = mul(x[i0] - x[i1], tw[s, k]),  tw[s, k] = w^(k << s) (Montgomery
//   form over Fp<L>, plain for goldilocks)
// where k = 0 stands for w^0 = one: tw[s, 0] is never read (the plain
// version takes it as one too).
// Every stored value is canonical, so the kernel is bit-exact against the
// plain version (ntt_wide.py dif_rows_wide_ref) at every plan.
//
// Layouts, as dif_rows: default x, out (rows, N) elements, out rows in
// bit-reversed order; transpose_in: x (and factor) (N, rows), row r the
// column x[:, r]; transpose_out: out (N, rows), out[bitrev(j), r] = y_r[j].
// With them the four-step NTT is two launches and no other kernel
// (ntt_wide.py ntt_four_step_wide).
//
// Design (ntt_dif.cu's, carried over to wide elements):
// - Stages in registers. The log_n stages split into groups of at most
//   kMaxGroup index bits. In a group over index bits [lo, lo + G) a
//   thread holds one chunk, the 2^G elements whose indices differ only in
//   those bits, and runs the G stages in registers; shared memory carries
//   the data between groups, one barrier a group (4 at log_n 12 for Gl64,
//   not 12). The caller plans the groups (ntt_wide.py `group_sizes`, up to
//   its GROUP, which is kMaxGroup: the kernel's registers are those of its
//   largest group); the launch checks them against kMaxGroup. kMaxGroup
//   from ptxas's figures and the H100 (PERF.md §6): 3 for Gl64 (124
//   registers, no spill; at 5 it spilled 840 B and ran a 2^24 pass in
//   0.50-0.58 ms against 0.32-0.38), 2 for Fp<8> (at 3 a thread's eight
//   8-word elements beside the multiply's chains spilled 1,256 B and took
//   a pass from 0.55-0.67 to 0.89-1.03 ms) and 2 for Fp<12> (1 spills
//   less, runs within 5% and allows clusters of 2 only). Every instance
//   takes 256 threads a block and the 128 registers of two blocks an SM;
//   with 255 registers (one block, no spill) Fp<8> ran 10-20% slower.
//   The first group loads its chunks from global memory (times the
//   factor); the last (lo = 0) stores them, canonical, to global memory;
//   its butterflies whose twiddle is w^0 (known at compile time there)
//   skip the multiply; in the others the chunk whose k is 0 multiplies by
//   the instance's one. One kernel an instance: the group sizes are run-time
//   values (Pass::size), each size a compile-time instance of the group.
// - Rows that span a thread-block cluster. A tile of TR rows is split into
//   `cluster` (1, 2, 4 or 8) blocks, each holding a contiguous 1/cluster
//   slice of every row in its shared memory. In DIF order the top
//   log2(cluster) stages pair indices across slices; they are in the first
//   group (its size is at least log2(cluster), so groups of 2 bits allow
//   clusters of up to 4), whose chunks each block reads for its share of
//   the chunk bases straight from global memory; after its stages each
//   element goes to the shared memory of the block that owns its slice,
//   through distributed shared memory (map_shared_rank). A cluster
//   barrier (release / acquire) follows; the other groups run within each
//   block. The cluster is also how a tile too large for two blocks an SM
//   is split (`wide_plan`): a goldilocks tile of 4 rows of 2^12 takes two
//   blocks of 67.6 KB. A relaxed cluster barrier at the start makes sure
//   every block of the cluster runs before any writes to it.
// - Shared memory: each element's 32-bit words in planes (word w of slice
//   index i at w * plane + pad(i)), pad(i) = i + i/32, so a warp's words
//   of one plane fall on distinct banks wherever the chunk bases are
//   consecutive (lo >= 5) or 2^G apart (the last group); rows are skewed by
//   32/TR words, so that the TR rows of one index (the transposed layouts'
//   mappings, rows fastest) do too. Groups with 0 < lo < 5 (one of Gl64's
//   four at log_n 12, two of Fp<8>'s six at 11) take some conflicts.
// - Twiddles are read through the read-only path (__ldg) from the
//   (log_n, N) stage table, whose stage row s holds the compact row
//   w^(k << s), 0 < k < m, at its start: consecutive threads read consecutive
//   entries (lo >= 5) or one entry (lo = 0), each twiddle once a chunk.
//   They are not staged in shared memory: at 8 and 12 limbs a row and its
//   compact twiddles do not fit one block together (at 2^12, 128 KB + 128
//   KB, or 192 KB + 192 KB), and Gl64's N - 1 words (32 KB at 2^12) stay
//   in L1 beside its 67.6 KB slices.
// - Transposed layouts: the first group with transpose_in and the last
//   with transpose_out map chunks rows fastest, so a warp moves runs of TR
//   elements: Gl64 takes TR = 4 rows a tile, 32-byte sectors; an Fp<8> or
//   Fp<12> element is one sector or more (TR = 1).
//
// Arithmetic (each instance a struct below: add, sub, mul, canonical):
//   Gl64: gl64.cuh's lazy representatives: between the load and the store
//     a value is any 64-bit word congruent to it mod p (lazy_add,
//     lazy_sub, lazy_mul: carry chains, a carry or borrow out of 64 bits
//     folded back as eps = 2^64 mod p), `canonical` at the store.
//   Fp<8>, Fp<12>: ec_wide.cuh's carry-chain wide::mul / add / sub over
//     BaseConsts<L> (wide::wide_consts of the host constants). Where 4p <
//     2^(32 L) (wide::lazy_ok: bn254_scalar, bls12_377_scalar,
//     grumpkin_scalar, stark252, both 12-limb fields) values stay lazy in
//     [0, 2p) and are made canonical at the store; bls12_381_scalar (4p >
//     2^256) takes the canonical instance, every operation followed by
//     `canonical` (as poseidon_limbs.cu's Wide8<false>), chosen from the
//     constants at launch. Canonical times a Montgomery twiddle is the
//     canonical product, so the stored bits are the plain version's.
//
// Bound. A row of N = 2^log_n needs log_n N / 2 - (N - 1) multiplies (the
// N - 1 butterflies whose twiddle is w^0 need none), N more with the
// factor. Goldilocks 2^24 as two passes of 4096 x 4096: bytes, 671 MB (x,
// out, the inter-pass factor) at 3.35 TB/s, 0.20 ms, above its multiplies
// at 8 integer multiplies each. bn254_scalar 2^22 as two passes of 2048 x
// 2048: multiplies, 8-limb Montgomery multiplies of 264 integer
// multiplies, 0.66 ms, above 671 MB of bytes (0.20 ms); bw6_761_scalar
// 2^22 likewise, 12-limb multiplies of 588, 1.47 ms. chip_smoke.py
// (`dif_rows_wide_bound`) prints each per launch.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "ec_wide.cuh"
#include "gl64.cuh"

#ifndef ICICLE_EC_LIMBS
#define ICICLE_EC_LIMBS 8
#endif

namespace cg = cooperative_groups;

namespace {

namespace wide = icicle_ec::wide;

constexpr int kMaxGroups = 24;
constexpr int kMaxCluster = 8;  // the portable cluster size

struct Gl64 {
  static constexpr int W = 2;        // 32-bit words an element
  static constexpr int kMaxGroup = 3;  // index bits a group, at most
  static constexpr int kThreads = 256, kMinBlocks = 2;
  using E = uint64_t;
  struct C {};  // nothing at run time
  static __device__ __forceinline__ E one(const C&) { return 1; }
  static __device__ __forceinline__ E add(E a, E b, const C&) { return icicle_gl::lazy_add(a, b); }
  static __device__ __forceinline__ E sub(E a, E b, const C&) { return icicle_gl::lazy_sub(a, b); }
  static __device__ __forceinline__ E mul(E a, E b, const C&) { return icicle_gl::lazy_mul(a, b); }
  static __device__ __forceinline__ E canonical(E a, const C&) { return icicle_gl::canonical(a); }
  static __device__ __forceinline__ E load(const uint32_t* src, size_t i) {
    return __ldg(reinterpret_cast<const unsigned long long*>(src) + i);
  }
  static __device__ __forceinline__ void store(uint32_t* dst, size_t i, E a) {
    reinterpret_cast<uint64_t*>(dst)[i] = a;
  }
  static __device__ __forceinline__ E from_smem(const uint32_t* s, int plane) {
    return icicle_gl::join(s[0], s[plane]);
  }
  static __device__ __forceinline__ void to_smem(uint32_t* s, int plane, E a) {
    s[0] = icicle_gl::lo32(a);
    s[plane] = icicle_gl::hi32(a);
  }
};

// An NL-limb field over ec_wide.cuh; kLazy: values in [0, 2p) (needs 4p <
// 2^(32 NL)), else canonical after every operation.
template <int NL, bool kLazy>
struct FpWide {
  static constexpr int W = NL;
  static constexpr int kMaxGroup = 2;
  static constexpr int kThreads = 256, kMinBlocks = 2;
  using E = icicle_ec::Fp<NL>;
  using C = wide::BaseConsts<NL>;
  static __device__ __forceinline__ E one(const C& c) {  // R mod p
    E a;
#pragma unroll
    for (int w = 0; w < NL; ++w) a.v[w] = c.one[w];
    return a;
  }
  static __device__ __forceinline__ E add(const E& a, const E& b, const C& c) {
    const E r = wide::add<NL>(a, b, c);
    return kLazy ? r : wide::canonical<NL>(r, c);
  }
  static __device__ __forceinline__ E sub(const E& a, const E& b, const C& c) {
    const E r = wide::sub<NL>(a, b, c);
    return kLazy ? r : wide::canonical<NL>(r, c);
  }
  static __device__ __forceinline__ E mul(const E& a, const E& b, const C& c) {
    const E r = wide::mul<NL>(a, b, c);
    return kLazy ? r : wide::canonical<NL>(r, c);
  }
  static __device__ __forceinline__ E canonical(const E& a, const C& c) {
    return kLazy ? wide::canonical<NL>(a, c) : a;
  }
  // NL * 4 bytes an element, 16-byte aligned: NL / 4 16-byte loads and stores
  static __device__ __forceinline__ E load(const uint32_t* src, size_t i) {
    const uint4* s = reinterpret_cast<const uint4*>(src + i * NL);
    E a;
#pragma unroll
    for (int q = 0; q < NL / 4; ++q) {
      const uint4 u = __ldg(s + q);
      a.v[4 * q] = u.x;
      a.v[4 * q + 1] = u.y;
      a.v[4 * q + 2] = u.z;
      a.v[4 * q + 3] = u.w;
    }
    return a;
  }
  static __device__ __forceinline__ void store(uint32_t* dst, size_t i, const E& a) {
    uint4* d = reinterpret_cast<uint4*>(dst + i * NL);
#pragma unroll
    for (int q = 0; q < NL / 4; ++q)
      d[q] = make_uint4(a.v[4 * q], a.v[4 * q + 1], a.v[4 * q + 2], a.v[4 * q + 3]);
  }
  static __device__ __forceinline__ E from_smem(const uint32_t* s, int plane) {
    E a;
#pragma unroll
    for (int w = 0; w < NL; ++w) a.v[w] = s[w * plane];
    return a;
  }
  static __device__ __forceinline__ void to_smem(uint32_t* s, int plane, const E& a) {
#pragma unroll
    for (int w = 0; w < NL; ++w) s[w * plane] = a.v[w];
  }
};

template <class F>
struct Pass {
  const uint32_t* x;
  const uint32_t* factor;  // null, or x's shape and layout
  const uint32_t* tw;      // (log_n, N) stage table
  uint32_t* out;
  int rows, log_n, log_tr, log_c;  // log_c: log2 of the blocks a cluster
  int plane, row_words;            // shared memory strides, in 32-bit words
  int groups;
  int8_t size[kMaxGroups];         // each group's index bits, top first
  int tin, tout;
  typename F::C c;
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// One stage group (index bits [lo, lo + G)) of one tile: each chunk's 2^G
// elements in registers. The first group reads global memory (times the
// factor) and writes each element to the block that owns its slice; the
// others read and write the block's own slice; the last stores to global
// memory.
template <class F, int G, bool FIRST, bool LAST>
__device__ __forceinline__ void run_group(const Pass<F>& P, int lo, uint32_t* buf, int r0,
                                          int rank, cg::cluster_group& cluster) {
  using E = typename F::E;
  constexpr int NE = 1 << G;
  const int log_s = P.log_n - P.log_c;  // a block's slice of a row: 2^log_s elements
  // chunks a row in this block: the first group's bases (bits [0, lo)) are
  // shared out among the cluster's blocks; the others' cover the slice
  const int log_chunks = FIRST ? lo - P.log_c : log_s - G;
  const int log_tr = P.log_tr;
  const bool row_fast = FIRST ? P.tin != 0 : (LAST && P.tout != 0);
  const int items = 1 << (log_chunks + log_tr);
#pragma unroll 1
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    int row, cc;
    if (row_fast) {
      row = it & ((1 << log_tr) - 1);
      cc = it >> log_tr;
    } else {
      row = it >> log_chunks;
      cc = it & ((1 << log_chunks) - 1);
    }
    // blo: the chunk's index bits below lo (its twiddles' offset); base:
    // the index of its element 0, in the row (first group) or the slice
    const int blo = FIRST ? (rank << log_chunks) + cc : cc & ((1 << lo) - 1);
    const int base = FIRST ? blo : blo | ((cc >> lo) << (lo + G));

    E v[NE];
    if constexpr (FIRST) {
      const size_t at0 = P.tin ? static_cast<size_t>(base) * P.rows + r0 + row
                               : (static_cast<size_t>(r0 + row) << P.log_n) + base;
      const size_t step = P.tin ? static_cast<size_t>(P.rows) << lo : size_t{1} << lo;
#pragma unroll
      for (int j = 0; j < NE; ++j) v[j] = F::load(P.x, at0 + j * step);
      if (P.factor != nullptr) {
#pragma unroll
        for (int j = 0; j < NE; ++j) v[j] = F::mul(v[j], F::load(P.factor, at0 + j * step), P.c);
      }
    } else {
      const uint32_t* s = buf + row * P.row_words;
#pragma unroll
      for (int j = 0; j < NE; ++j) v[j] = F::from_smem(s + pad(base + (j << lo)), P.plane);
    }

#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int hm = NE >> (t + 1);            // partner distance in j
      const int stage = P.log_n - lo - G + t;  // index bit lo + G - 1 - t
      const uint32_t* tws = P.tw + (static_cast<size_t>(stage) << P.log_n) * F::W;
#pragma unroll
      for (int kk = 0; kk < hm; ++kk) {
        // k = blo + (kk << lo); k = 0 is w^0 = one, not read from the
        // table; in the last group (lo = 0, blo = 0) k = kk, so it is known
        // at compile time there and skips the multiply
        const bool unit = LAST && kk == 0;
        E w{};
        if (!unit) w = kk == 0 && blo == 0 ? F::one(P.c) : F::load(tws, blo + (kk << lo));
#pragma unroll
        for (int j0 = kk; j0 < NE; j0 += 2 * hm) {
          const E top = v[j0], bot = v[j0 + hm];
          v[j0] = F::add(top, bot, P.c);
          const E d = F::sub(top, bot, P.c);
          v[j0 + hm] = unit ? d : F::mul(d, w, P.c);
        }
      }
    }

    if constexpr (LAST) {
      // lo = 0: element j is the row's index (rank << log_s) + base + j
      const int i0 = (rank << log_s) + base;
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        const E y = F::canonical(v[j], P.c);
        if (P.tout) {
          const unsigned k = __brev(static_cast<unsigned>(i0 + j)) >> (32 - P.log_n);
          F::store(P.out, static_cast<size_t>(k) * P.rows + r0 + row, y);
        } else {
          F::store(P.out, (static_cast<size_t>(r0 + row) << P.log_n) + i0 + j, y);
        }
      }
    } else if constexpr (FIRST) {
      // element j, the row's index base + (j << lo), lies in slice
      // j >> (G - log_c) at base + ((j mod 2^(G - log_c)) << lo)
      const int own = G - P.log_c;
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        uint32_t* dst = P.log_c ? cluster.map_shared_rank(buf, j >> own) : buf;
        F::to_smem(dst + row * P.row_words + pad(base + ((j & ((1 << own) - 1)) << lo)), P.plane,
                   v[j]);
      }
    } else {
      uint32_t* s = buf + row * P.row_words;
#pragma unroll
      for (int j = 0; j < NE; ++j) F::to_smem(s + pad(base + (j << lo)), P.plane, v[j]);
    }
  }
}

// run_group at the group's size g, one compile-time instance a size.
template <class F, bool FIRST, bool LAST, int G = 1>
__device__ __forceinline__ void run_sized(int g, const Pass<F>& P, int lo, uint32_t* buf, int r0,
                                          int rank, cg::cluster_group& cluster) {
  if (g == G) {
    run_group<F, G, FIRST, LAST>(P, lo, buf, r0, rank, cluster);
    return;
  }
  if constexpr (G < F::kMaxGroup) run_sized<F, FIRST, LAST, G + 1>(g, P, lo, buf, r0, rank, cluster);
}

// One cluster a tile of TR = 2^log_tr rows; block `rank` of the cluster
// holds slice `rank` of each.
template <class F>
__global__ void __launch_bounds__(F::kThreads, F::kMinBlocks) dif_rows_wide_kernel(const Pass<F> P) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = P.log_c ? static_cast<int>(cluster.block_rank()) : 0;
  const int r0 = (static_cast<int>(blockIdx.x) >> P.log_c) << P.log_tr;
  if (P.log_c) {
    // every block of the cluster has started before the first group
    // writes to its shared memory
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
  int hi = P.log_n;
#pragma unroll 1
  for (int g = 0; g < P.groups; ++g) {
    const int G = P.size[g], lo = hi - G;
    const bool first = g == 0, last = g == P.groups - 1;
    if (first && last) run_sized<F, true, true>(G, P, lo, smem, r0, rank, cluster);
    else if (first) run_sized<F, true, false>(G, P, lo, smem, r0, rank, cluster);
    else if (last) run_sized<F, false, true>(G, P, lo, smem, r0, rank, cluster);
    else run_sized<F, false, false>(G, P, lo, smem, r0, rank, cluster);
    hi = lo;
    if (last) break;
    if (first && P.log_c) {
      // release / acquire: every block's slice written before any reads it
      asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    } else {
      __syncthreads();  // this group's shared-memory writes before the next reads
    }
  }
}

// A block's shared memory in words: TR rows of W planes of the slice (2^s
// elements, padded one word in 32), rows skewed by 32/TR words
// (ntt_wide.py smem_bytes).
int plane_words(int log_s) { return (1 << log_s) + ((1 << log_s) >> 5); }
int row_words(int w, int log_s, int tr) { return w * plane_words(log_s) + (tr > 1 ? 32 / tr : 0); }

// The caller's plan: `groups` stage groups of sizes[g] index bits, top
// first (ntt_wide.py group_sizes), each within the instance's kMaxGroup
// and together log_n.
template <class F>
int launch(Pass<F>& P, const int8_t* sizes, int groups, int tr, int threads, int cluster,
           int dev_smem_limit, cudaStream_t stream) {
  if (threads < 1 || threads > F::kThreads || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 || (1 << P.log_n) < cluster || sizes == nullptr ||
      groups < 1 || groups > kMaxGroups)
    return static_cast<int>(cudaErrorInvalidValue);
  int bits = 0;
  for (int g = 0; g < groups; ++g) {
    if (sizes[g] < 1 || sizes[g] > F::kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
    P.size[g] = sizes[g];
    bits += sizes[g];
  }
  if (bits != P.log_n) return static_cast<int>(cudaErrorInvalidValue);
  P.groups = groups;
  P.log_c = 31 - __builtin_clz(static_cast<unsigned>(cluster));
  // the first group holds the cross-slice stages and has a base for every block
  if (P.log_c && (P.groups < 2 || P.size[0] < P.log_c || P.log_n - P.size[0] < P.log_c))
    return static_cast<int>(cudaErrorInvalidValue);
  const int log_s = P.log_n - P.log_c;
  P.plane = plane_words(log_s);
  P.row_words = row_words(F::W, log_s, tr);
  const size_t smem = sizeof(uint32_t) * static_cast<size_t>(tr) * P.row_words;
  if (smem > static_cast<size_t>(dev_smem_limit)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(dif_rows_wide_kernel<F>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((P.rows / tr) * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dif_rows_wide_kernel<F>, P);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <class F>
Pass<F> make_pass(const void* x, const void* factor, const void* tw, void* out, int rows,
                  int log_n, int tr, int tin, int tout) {
  Pass<F> P = {};
  P.x = static_cast<const uint32_t*>(x);
  P.factor = static_cast<const uint32_t*>(factor);
  P.tw = static_cast<const uint32_t*>(tw);
  P.out = static_cast<uint32_t*>(out);
  P.rows = rows;
  P.log_n = log_n;
  P.log_tr = 31 - __builtin_clz(static_cast<unsigned>(tr));
  P.tin = tin;
  P.tout = tout;
  return P;
}

// The Fp<NL> instance of the constants {p[NL], one[NL], inv32, ...}: lazy
// where 4p < 2^(32 NL), else (kCanonical, 8 limbs only: no 12-limb field
// with an NTT lacks the two spare bits) canonical.
template <int NL, bool kCanonical>
int launch_fp(const unsigned int* consts, const void* x, const void* factor, const void* tw,
              void* out, int rows, int log_n, const int8_t* sizes, int groups, int tr,
              int threads, int cluster, int tin, int tout, int smem_limit, cudaStream_t s) {
  const wide::BaseConsts<NL> c = wide::base_consts<NL>(icicle_ec::consts_from<NL>(consts));
  if (wide::lazy_ok(c)) {
    Pass<FpWide<NL, true>> P =
        make_pass<FpWide<NL, true>>(x, factor, tw, out, rows, log_n, tr, tin, tout);
    P.c = c;
    return launch(P, sizes, groups, tr, threads, cluster, smem_limit, s);
  }
  if constexpr (kCanonical) {
    // wide::add's one conditional subtraction of 2p and wide::mul's
    // operand bound need 2p < 2^(32 NL)
    if ((c.p[NL - 1] >> 31) == 0) {
      Pass<FpWide<NL, false>> P =
          make_pass<FpWide<NL, false>>(x, factor, tw, out, rows, log_n, tr, tin, tout);
      P.c = c;
      return launch(P, sizes, groups, tr, threads, cluster, smem_limit, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches the pass on `stream` without synchronising. kind: 0 goldilocks
// (libntt_wide), 1 an 8-limb field below 2^255 (libntt_wide), 2 a 12-limb
// field with 4p < 2^384 (libntt_wide_l12); the library refuses a kind it
// was not built with. consts: the field's host array {p[L], one[L],
// inv32, ...} (null for goldilocks). Device pointers: x, out with rows *
// 2^log_n elements (2, 8 or 12 words each) in their layouts, factor
// likewise or null, tw (log_n, 2^log_n) elements. tr (a power of two
// dividing rows) rows a tile, `threads` a block, `cluster` (1, 2, 4 or 8)
// blocks a tile, each holding 1/cluster of every row; sizes: host array
// of the `groups` stage groups' index bits, top first. Returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue for a refused
// plan).
int icicle_ntt_dif_rows_wide(int kind, const void* x, const void* factor, const void* tw,
                             void* out, int rows, int log_n, int tr, int threads, int cluster,
                             const int8_t* sizes, int groups, int transpose_in, int transpose_out,
                             const unsigned int* consts, void* stream) {
  if (rows < 1 || tr < 1 || (tr & (tr - 1)) != 0 || rows % tr != 0 || log_n < 1 || log_n > 24)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#if ICICLE_EC_LIMBS == 8
  if (kind == 0) {
    Pass<Gl64> P = make_pass<Gl64>(x, factor, tw, out, rows, log_n, tr, transpose_in,
                                   transpose_out);
    return launch(P, sizes, groups, tr, threads, cluster, smem_limit, s);
  }
  if (kind == 1 && consts != nullptr)
    return launch_fp<8, true>(consts, x, factor, tw, out, rows, log_n, sizes, groups, tr,
                              threads, cluster, transpose_in, transpose_out, smem_limit, s);
#elif ICICLE_EC_LIMBS == 12
  if (kind == 2 && consts != nullptr)
    return launch_fp<12, false>(consts, x, factor, tw, out, rows, log_n, sizes, groups, tr,
                                threads, cluster, transpose_in, transpose_out, smem_limit, s);
#else
#error "ntt_wide.cu is built at ICICLE_EC_LIMBS 8 or 12"
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
