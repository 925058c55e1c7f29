// Fused radix-2 DIF pass over the rows of a matrix of Mont32 field elements,
// for NVIDIA Hopper (sm_90a). Bound to Python with ctypes
// (icicle_tpu_torch/kernels/ntt_kernel.py: dif_rows).
//
// Replaces both TPU kernels of the NTT main path, which compute one function:
//   B1  icicle_tpu/pallas/ntt_kernel.py:53  make_dif_kernel
//   B2  icicle_tpu/pallas/ntt_kernel.py:172 make_dif_kernel_mxu
// B2's last seven stages as bf16 digit-plane matmuls are a device of the
// TPU's matrix unit and are not carried over; its pre_mul factor is the
// `factor` argument here.
//
// Function. Row r of length N = 2^log_n goes through all log_n DIF stages
// (times `factor` on load when given): natural order in, bit-reversed order
// out. Stage s, half-block m = N >> (s+1), butterfly on (i0, i1 = i0 + m):
//   y[i0] = x[i0] + x[i1]
//   y[i1] = mont(x[i0] - x[i1], tw[s, i1]),  tw[s, i] = w^((i & (m-1)) << s) R
// exactly the Pallas stage (ntt_kernel.py:97-106). Every butterfly is the
// same exact operation on canonical values (< p < 2^31) in any grouping, so
// the kernel is bit-exact against the plain version at every plan. The
// wrapper checks p, dtype and shapes, not the values.
//
// Layouts. Default: x and out are (rows, N), row r = x[r, :], out[r, :] in
// bit-reversed order. `transpose_in`: x (and factor) are (N, rows), row r is
// the column x[:, r]. `transpose_out`: out is (N, rows), out[k, r] = the
// natural-order transform of row r at k, i.e. out[bitrev(j), r] = y_r[j].
// With them the four-step NTT is two launches and no other kernel
// (ntt_kernel.py ntt_four_step_cuda).
//
// Bound: bytes. A pass reads x (and factor) and writes out once: rows * N *
// 4 * 2 bytes (* 3 with factor) at 3.35 TB/s, 0.16 ms (0.24 ms) at the
// 2^26 NTT's (8192, 8192). Its log_n * N/2 Montgomery multiplies a row
// (three 32-bit multiplies each, at 16.7 T/s) take about half of that, but
// every butterfly also costs adds, a twiddle read and its share of the
// shared-memory exchanges, so in practice the kernel is bound by
// instruction issue, not by bytes.
//
// Design, against the costs of the first version (one row a block, a
// barrier and a shared-memory round trip per stage, twiddles read from the
// (log_n, N) table in L2 per stage, 2-way bank conflicts below m = 32):
// - Stages in registers. The log_n stages split into groups of at most 5
//   (`group_size`, compile-time per log_n): the last group takes the low 5
//   index bits, the others the rest, evenly (4 + 4 + 5 at log_n 13). In a
//   group over index bits [LO, LO + G) a thread holds the 2^G elements of
//   one "chunk" (the indices that differ only in those bits) in registers
//   and runs the group's G stages there. The first group loads its chunks
//   from global memory (LO >= 5 there, so neighbouring threads read
//   neighbouring words); every group leaves its chunks in the tile buffer
//   in shared memory: 3 barriers a tile at log_n 13, not 13. Butterflies
//   whose twiddle is w^0 (known at compile time in the last group) skip the
//   multiply, and a difference enters the multiply unreduced.
// - No bank conflicts. Shared-memory rows are padded by one word in 32
//   (index i at i + i/32), so a thread's 32 consecutive words in the last
//   group fall on distinct banks across a warp; rows are skewed by 32/TR
//   more words, so threads of one index and TR rows (the transposed
//   layouts' mappings) do too. Groups with LO >= 5 read consecutive words.
//   As LO is 0 or >= 5, a chunk's words sit at pad(base) + j * pad(2^LO):
//   one address a chunk, the rest immediate offsets.
// - Twiddles staged once per block. Blocks are persistent (a grid of the
//   clusters that fit at once, looping over tiles of TR rows) and copy,
//   once, the first 2^(log_n-1-s) entries of each stage row s of the table
//   into shared memory: N - 1 words (32 KB at log_n 13). These compact rows
//   make a group's twiddle reads conflict-free (consecutive words across
//   threads, or one broadcast word), where one power table w^j indexed
//   (i & (m-1)) << s would put a warp's reads 2^s words apart.
// - Transposed layouts. With transpose_in the first group maps a tile's
//   chunks rows fastest, so a warp reads runs of TR words. With
//   transpose_out a cluster of 8 / TR blocks (thread block clusters) stores
//   its 8 rows together: each block writes its share of the N positions for
//   all 8 rows, reading the other blocks' tiles through distributed shared
//   memory, so that every run is a whole 32-byte sector; runs of 16 bytes
//   from one block of 4 rows cost half as much again (the sectors' other
//   halves are written later, by other blocks). The cluster barrier before
//   that store releases and acquires; the one after it is relaxed.
// - TR (ntt_kernel.py dif_plan): 1-2 rows at log_n 12-14 in the default
//   layout, so that blocks share an SM and one loads while the others
//   compute; 2-8 in the transposed layouts, whose column reads want runs of
//   TR words and whose stores want fewer blocks a cluster.
// ptxas: 59-64 registers from log_n 6 to 14, no stack, no spills.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLogN = 14;
constexpr int kMaxGroup = 5;  // 2^5 elements in registers a thread
constexpr int kMaxThreads = 512;

// Stage groups, top index bits first: the last takes the low min(L, 5)
// bits, the others the rest, evenly (larger ones first).
__host__ __device__ constexpr int low_bits(int L) { return L < kMaxGroup ? L : kMaxGroup; }
__host__ __device__ constexpr int upper_groups(int L) {
  return (L - low_bits(L) + kMaxGroup - 1) / kMaxGroup;
}
__host__ __device__ constexpr int num_groups(int L) { return upper_groups(L) + 1; }
__host__ __device__ constexpr int group_size(int L, int g) {
  return g < upper_groups(L)
             ? (L - low_bits(L)) / upper_groups(L) +
                   (g < (L - low_bits(L)) % upper_groups(L) ? 1 : 0)
             : low_bits(L);
}
__host__ __device__ constexpr int group_lo(int L, int g) {
  int top = L;
  for (int h = 0; h <= g; ++h) top -= group_size(L, h);
  return top;
}

struct Pass {
  const uint32_t* x;
  const uint32_t* factor;  // null, or x's shape and layout
  const uint32_t* tw;      // (log_n, N) stage table
  uint32_t* out;
  int rows, log_tr, stride;  // stride: a row's words in shared memory
  uint32_t p, pinv;          // pinv = p^-1 mod 2^32
  int tin, tout;
};

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t pinv) {
  // For any a < 2^32 and b < p: a * b - m * p (m = lo * p^-1) is a multiple
  // of 2^32 below 2^32 p in magnitude, so its high word hi - mp_hi is the
  // Montgomery product in (-p, p); as uint32, min(r, r + p) is canonical.
  const uint32_t lo = a * b;
  const uint32_t hi = __umulhi(a, b);
  const uint32_t r = hi - __umulhi(lo * pinv, p);
  return min(r, r + p);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;  // < 2p < 2^32; s - p wraps above s when s < p
  return min(s, s - p);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t d = a - b;  // wraps when a < b; d + p then wraps back below p
  return min(d, d + p);
}

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// One stage group (index bits [LO, LO + G)) of one tile: each chunk's 2^G
// elements in registers. The first group reads global memory (times the
// factor), every group leaves its results in the tile buffer.
template <int L, int G, int LO, bool FIRST>
__device__ __forceinline__ void run_group(const Pass& P, const uint32_t* tws,
                                          uint32_t* buf, int r0) {
  constexpr int E = 1 << G;
  constexpr int LOG_CHUNKS = L - G;  // chunks a row
  // LO = 0 or LO >= 5, so pad(base + (j << LO)) = pad(base) + j * STEP
  constexpr int STEP = (1 << LO) + ((1 << LO) >> 5);
  // rows fastest where the chunks come from columns: TR-word runs
  const bool row_fast = FIRST && P.tin;
  for (int c = threadIdx.x; c < 1 << (LOG_CHUNKS + P.log_tr); c += blockDim.x) {
    int row, cc;
    if (row_fast) {
      row = c & ((1 << P.log_tr) - 1);
      cc = c >> P.log_tr;
    } else {
      row = c >> LOG_CHUNKS;
      cc = c & ((1 << LOG_CHUNKS) - 1);
    }
    const int blo = cc & ((1 << LO) - 1);
    const int base = blo | ((cc >> LO) << (LO + G));
    uint32_t* sp = buf + row * P.stride + pad(base);

    uint32_t v[E];
    if constexpr (FIRST) {
      const size_t at0 = P.tin ? static_cast<size_t>(base) * P.rows + r0 + row
                               : (static_cast<size_t>(r0 + row) << L) + base;
      const size_t step = P.tin ? static_cast<size_t>(P.rows) << LO : size_t{1} << LO;
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = P.x[at0 + j * step];
      if (P.factor) {
#pragma unroll
        for (int j = 0; j < E; ++j) v[j] = mont_mul(v[j], P.factor[at0 + j * step], P.p, P.pinv);
      }
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = sp[j * STEP];
    }

#pragma unroll
    for (int t = 0; t < G; ++t) {
      const int hm = E >> (t + 1);   // partner distance in j
      const int b = LO + G - 1 - t;  // index bit: stage L - 1 - b
      // its compact row, T[k] = w^(k << stage) for k < 2^b, at N - 2^(b+1)
      const uint32_t* ts = tws + ((1 << L) - (2 << b)) + blo;
#pragma unroll
      for (int j0 = 0; j0 < E; ++j0) {
        if (j0 & hm) continue;
        const int j1 = j0 + hm;
        const int k = (j0 & (hm - 1)) << LO;
        const uint32_t top = v[j0], bot = v[j1];
        v[j0] = add_mod(top, bot, P.p);
        // T[0] = w^0 R: mont(d, R) = d, known here where LO = 0 (blo = 0);
        // else the difference enters the multiply unreduced, below 2p
        v[j1] = (LO == 0 && k == 0) ? sub_mod(top, bot, P.p)
                                    : mont_mul(top + P.p - bot, ts[k], P.p, P.pinv);
      }
    }

#pragma unroll
    for (int j = 0; j < E; ++j) sp[j * STEP] = v[j];
  }
}

template <int L, int g>
__device__ __forceinline__ void run_groups(const Pass& P, const uint32_t* tws,
                                           uint32_t* buf, int r0) {
  constexpr int last = num_groups(L) - 1;
  run_group<L, group_size(L, g), group_lo(L, g), g == 0>(P, tws, buf, r0);
  if constexpr (g < last) {
    __syncthreads();  // this group's shared-memory writes before the next reads
    run_groups<L, g + 1>(P, tws, buf, r0);
  }
}

// The store of a tile whose results sit in position (bit-reversed) order in
// the blocks' tile buffers. Default layout: each block its TR rows, four
// words a thread, a warp 512 contiguous bytes. Transposed: the cluster's
// RT = TR * cluster rows; block `rank` writes the positions i of its
// N / cluster share for all of them, out[bitrev(i), R0 + row], reading the
// other blocks' rows through distributed shared memory, so that a warp
// writes 32 / RT runs of RT words.
template <int L>
__device__ __forceinline__ void store_tile(const Pass& P, const uint32_t* buf,
                                           cg::cluster_group& cluster, int R0) {
  if (!P.tout) {
    uint32_t* o = P.out + (static_cast<size_t>(R0) << L);  // the tile's rows are contiguous
    if constexpr (L >= 2) {
      for (int e = 4 * threadIdx.x; e < 1 << (L + P.log_tr); e += 4 * blockDim.x) {
        // i = e mod N is a multiple of 4: i..i+3 sit at pad(i)..pad(i)+3
        const uint32_t* s = buf + (e >> L) * P.stride + pad(e & ((1 << L) - 1));
        *reinterpret_cast<uint4*>(o + e) = make_uint4(s[0], s[1], s[2], s[3]);
      }
    } else {
      for (int e = threadIdx.x; e < 1 << (L + P.log_tr); e += blockDim.x)
        o[e] = buf[(e >> L) * P.stride + (e & ((1 << L) - 1))];
    }
    return;
  }
  const int csize = static_cast<int>(cluster.num_blocks());
  const int log_rt = P.log_tr + (31 - __clz(csize));
  const int span = (1 << L) / csize;
  const int i0 = static_cast<int>(cluster.block_rank()) * span;
  // blockDim is a multiple of RT <= 32: a thread keeps one row
  const int row = threadIdx.x & ((1 << log_rt) - 1);
  const uint32_t* src = cluster.map_shared_rank(buf, row >> P.log_tr) +
                        (row & ((1 << P.log_tr) - 1)) * P.stride;
  uint32_t* dst = P.out + R0 + row;
  for (int i = i0 + (threadIdx.x >> log_rt); i < i0 + span; i += blockDim.x >> log_rt) {
    const unsigned k = __brev(static_cast<unsigned>(i)) >> (32 - L);
    dst[static_cast<size_t>(k) * P.rows] = src[pad(i)];
  }
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads) dif_rows_kernel(Pass P) {
  extern __shared__ uint32_t smem[];
  constexpr int N = 1 << L;
  uint32_t* tws = smem;      // N - 1 words: the compact stage rows
  uint32_t* buf = smem + N;  // the tile: TR rows of P.stride words

#pragma unroll
  for (int s = 0; s < L; ++s) {
    const int m = N >> (s + 1);
    for (int k = threadIdx.x; k < m; k += blockDim.x)
      tws[N - 2 * m + k] = P.tw[(static_cast<size_t>(s) << L) + k];
  }
  __syncthreads();

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rows_per_ctile = csize << P.log_tr;
  const int ctiles = P.rows / rows_per_ctile;
  const int rank_rows = static_cast<int>(cluster.block_rank()) << P.log_tr;
  for (int ct = static_cast<int>(blockIdx.x) / csize; ct < ctiles;
       ct += static_cast<int>(gridDim.x) / csize) {
    const int R0 = ct * rows_per_ctile;
    run_groups<L, 0>(P, tws, buf, R0 + rank_rows);
    if (csize == 1) {
      __syncthreads();
      store_tile<L>(P, buf, cluster, R0);
      __syncthreads();  // read before the next tile writes the buffer
    } else {
      // release/acquire: every block's results in its shared memory
      asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      store_tile<L>(P, buf, cluster, R0);
      // relaxed: the reads are done before any block writes its buffer again
      asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    }
  }
}

// Shared memory one block needs: the compact stage rows (N words) and a
// tile of TR rows, each padded by one word in 32 and skewed by 32/TR words
// (ntt_kernel.py dif_smem_bytes; its dif_plan keeps this within 232,448
// bytes).
int row_stride(int log_n, int tr) {
  const int n = 1 << log_n;
  return n + n / 32 + (tr < 32 ? 32 / tr : 1);
}

size_t smem_bytes(int log_n, int tr) {
  return sizeof(uint32_t) * ((static_cast<size_t>(1) << log_n) +
                             static_cast<size_t>(tr) * row_stride(log_n, tr));
}

template <int L>
cudaError_t launch(const Pass& P, int tr, int threads, int cluster, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  const int ctiles = P.rows / (tr * cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctiles * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes(L, tr);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaFuncSetAttribute(dif_rows_kernel<L>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(cfg.dynamicSmemBytes));
  if (e != cudaSuccess) return e;
  // persistent blocks: at most the clusters that are resident at once
  int resident = 0;
  e = cudaOccupancyMaxActiveClusters(&resident, reinterpret_cast<const void*>(dif_rows_kernel<L>),
                                     &cfg);
  if (e != cudaSuccess) return e;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  if (resident < ctiles) cfg.gridDim = dim3(resident * cluster);
  e = cudaLaunchKernelEx(&cfg, dif_rows_kernel<L>, P);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int L = 1>
cudaError_t dispatch(int log_n, const Pass& P, int tr, int threads, int cluster,
                     cudaStream_t stream) {
  if (log_n == L) return launch<L>(P, tr, threads, cluster, stream);
  if constexpr (L < kMaxLogN) return dispatch<L + 1>(log_n, P, tr, threads, cluster, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the pass on `stream` without synchronising. All pointers are
// device pointers: x, out with rows * 2^log_n words in their layouts,
// factor likewise or null; tw (log_n, 2^log_n). tr (a power of two) rows a
// block's tile, `threads` a block, `cluster` blocks a cluster (a power of
// two, used by the transposed store; tr * cluster divides rows). Returns
// the launch's cudaError_t (0 on success).
int icicle_ntt_dif_rows(const void* x, const void* factor, const void* tw,
                        void* out, int rows, int log_n, unsigned int p,
                        unsigned int inv32, int tr, int threads, int cluster,
                        int transpose_in, int transpose_out, void* stream) {
  Pass P;
  P.x = static_cast<const uint32_t*>(x);
  P.factor = static_cast<const uint32_t*>(factor);
  P.tw = static_cast<const uint32_t*>(tw);
  P.out = static_cast<uint32_t*>(out);
  P.rows = rows;
  P.log_tr = 31 - __builtin_clz(static_cast<unsigned>(tr));
  P.stride = row_stride(log_n, tr);
  P.p = p;
  P.pinv = 0u - inv32;  // inv32 = -p^-1 mod 2^32
  P.tin = transpose_in;
  P.tout = transpose_out;
  return static_cast<int>(dispatch(log_n, P, tr, threads, cluster,
                                   static_cast<cudaStream_t>(stream)));
}

const char* icicle_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
