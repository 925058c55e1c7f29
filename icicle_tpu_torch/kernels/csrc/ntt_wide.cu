// Fused radix-2 DIF pass over the rows of a matrix of field elements wider
// than one word, for NVIDIA Hopper (sm_90a): goldilocks (one uint64 an
// element) and the 8-limb fields below 2^255 (ec_field.cuh's Montgomery
// arithmetic). Bound to Python with ctypes
// (icicle_tpu_torch/kernels/ntt_wide.py: dif_rows_wide).
//
// No TPU kernel is replaced: the JAX package computes the NTT of a limb
// field as XLA (icicle_tpu/ops/ntt.py:223-329, `_ntt_four_step` and
// `_ntt_vecfirst`), since its Pallas kernels take single-word fields only
// (ntt.py:342-344). The function is that of ntt_dif.cu's `dif_rows`, which
// keeps its own code for the single-word fields: row r of length N =
// 2^log_n goes through all log_n DIF stages (times `factor` on load when
// given), natural order in, bit-reversed order out. Stage s, half-block
// m = N >> (s+1), butterfly on (i0, i1 = i0 + m), k = i0 mod m:
//   y[i0] = x[i0] + x[i1]
//   y[i1] = mul(x[i0] - x[i1], tw[s, k]),  tw[s, k] = w^(k << s) (Montgomery
//   form for fp8, plain for gl64)
// Every operation returns canonical values, so the kernel is bit-exact
// against the plain version (ntt_wide.py dif_rows_wide_ref) at every plan.
//
// Layouts, as dif_rows: default x, out (rows, N) elements, out rows in
// bit-reversed order; transpose_in: x (and factor) (N, rows), row r the
// column x[:, r]; transpose_out: out (N, rows), out[bitrev(j), r] = y_r[j].
// With them the four-step NTT is two launches and no other kernel
// (ntt_wide.py ntt_four_step_wide).
//
// Arithmetic.
//   Gl64: gl64.cuh (p = 2^64 - 2^32 + 1, no Montgomery form; the carry of a
//     sum handled as 2^64 = eps; reduced differences, never a lazy one into
//     the multiply: the field has no slack bit).
//   Fp8: ec_field.cuh's mont_mul<8> (CIOS, R = 2^256), add_mod<8>,
//     sub_mod<8> with p and -p^-1 mod 2^32 at run time (kernel arguments);
//     mont_mul's one final subtraction needs 2p < 2^256, which the wrapper
//     checks (p < 2^255). Canonical times Montgomery twiddle is canonical.
//
// Bound. Goldilocks 2^24 as two passes of 4096 x 4096: bytes, 671 MB
// (x, out, the inter-pass factor) at 3.35 TB/s, 0.20 ms, above its (2^23 *
// 24 + 2^24) multiplies at 8 integer multiplies each (0.10 ms). bn254_scalar
// 2^22 as two passes of 2048 x 2048: multiplies, (2^21 * 22 + 2^22) 8-limb
// Montgomery multiplies of 264 integer multiplies, 0.79 ms, above 671 MB of
// bytes (0.20 ms). chip_smoke.py prints both per launch.
//
// Design: right and simple first (a later PR makes it fast). One block a
// tile of TR rows, held whole in shared memory (a 2^12 row of 32-byte
// elements is 128 KB; rows of up to 2^14 gl64 or 2^12 fp8 elements); every
// stage a pass of one butterfly a thread over the tile, with a barrier
// between stages. Twiddles are read from the (log_n, N) stage table through
// the read-only path (__ldg): the table of a pass is at most 1.5 MB and
// stays in L2, and keeping its compact rows in shared memory beside an fp8
// row of 2^12 would not fit. TR rows make a whole 32-byte sector of each
// column in the transposed layouts (TR = 4 for gl64, 1 for fp8), so column
// reads and the transposed store move whole sectors. The butterfly loop is
// rolled; mont_mul<8>'s limb loops are unrolled, as in the MSM kernels,
// whose CIOS keeps its accumulator in registers that way.

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"
#include "gl64.cuh"

namespace {

constexpr int kMaxThreads = 256;

struct Gl64 {
  using E = uint64_t;
  struct C {};  // nothing at run time
  static __device__ __forceinline__ E add(E a, E b, const C&) { return icicle_gl::add(a, b); }
  static __device__ __forceinline__ E sub(E a, E b, const C&) { return icicle_gl::sub(a, b); }
  static __device__ __forceinline__ E mul(E a, E b, const C&) { return icicle_gl::mul(a, b); }
  static __device__ __forceinline__ E load(const uint32_t* src, size_t i) {
    return __ldg(reinterpret_cast<const unsigned long long*>(src) + i);
  }
  static __device__ __forceinline__ void store(uint32_t* dst, size_t i, E a) {
    reinterpret_cast<uint64_t*>(dst)[i] = a;
  }
};

struct Fp8 {
  static constexpr int L = 8;
  using E = icicle_ec::Fp<L>;
  using C = icicle_ec::CurveConsts<L>;  // p, one, inv32; b3 unused
  static __device__ __forceinline__ E add(const E& a, const E& b, const C& c) {
    return icicle_ec::add_mod<L>(a, b, c);
  }
  static __device__ __forceinline__ E sub(const E& a, const E& b, const C& c) {
    return icicle_ec::sub_mod<L>(a, b, c);
  }
  static __device__ __forceinline__ E mul(const E& a, const E& b, const C& c) {
    return icicle_ec::mont_mul<L>(a, b, c);
  }
  // 32 bytes an element, 32-byte aligned: two 16-byte loads and stores
  static __device__ __forceinline__ E load(const uint32_t* src, size_t i) {
    const uint4* s = reinterpret_cast<const uint4*>(src + i * L);
    const uint4 a = __ldg(s), b = __ldg(s + 1);
    return E{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  }
  static __device__ __forceinline__ void store(uint32_t* dst, size_t i, const E& a) {
    uint4* d = reinterpret_cast<uint4*>(dst + i * L);
    d[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
    d[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
  }
};

template <class F>
struct Pass {
  const uint32_t* x;
  const uint32_t* factor;  // null, or x's shape and layout
  const uint32_t* tw;      // (log_n, N) stage table
  uint32_t* out;
  int rows, log_n, log_tr, tin, tout;
  typename F::C c;
};

// One block a tile of TR = 2^log_tr rows: load (times the factor), log_n
// stages in shared memory, store.
template <class F>
__global__ void __launch_bounds__(kMaxThreads) dif_rows_wide_kernel(const Pass<F> P) {
  using E = typename F::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* buf = reinterpret_cast<E*>(smem_raw);  // TR rows of N elements
  const int log_n = P.log_n, log_tr = P.log_tr;
  const int n = 1 << log_n, tr = 1 << log_tr;
  const int r0 = static_cast<int>(blockIdx.x) << log_tr;
  const int elems = tr << log_n;

  // load: rows fastest where the rows are columns (runs of TR elements)
#pragma unroll 1
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    int row, i;
    size_t at;
    if (P.tin) {
      row = e & (tr - 1);
      i = e >> log_tr;
      at = static_cast<size_t>(i) * P.rows + r0 + row;
    } else {
      row = e >> log_n;
      i = e & (n - 1);
      at = (static_cast<size_t>(r0 + row) << log_n) + i;
    }
    E v = F::load(P.x, at);
    if (P.factor != nullptr) v = F::mul(v, F::load(P.factor, at), P.c);
    buf[(row << log_n) + i] = v;
  }
  __syncthreads();

  const int half = elems >> 1;  // butterflies a stage over the tile
#pragma unroll 1
  for (int s = 0; s < log_n; ++s) {
    const int log_m = log_n - 1 - s;  // half-block m = 2^log_m
    const uint32_t* tws = P.tw;
#pragma unroll 1
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int row = b >> (log_n - 1);
      const int j = b & ((n >> 1) - 1);
      const int k = j & ((1 << log_m) - 1);
      const int i0 = ((j >> log_m) << (log_m + 1)) | k;
      E* r = buf + (row << log_n);
      const E top = r[i0], bot = r[i0 + (1 << log_m)];
      r[i0] = F::add(top, bot, P.c);
      r[i0 + (1 << log_m)] =
          F::mul(F::sub(top, bot, P.c), F::load(tws, (static_cast<size_t>(s) << log_n) + k), P.c);
    }
    __syncthreads();
  }

  // store: default, each row in position (bit-reversed) order; transposed,
  // out[k, r0 + row] = y at position bitrev(k), rows fastest
#pragma unroll 1
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    if (P.tout) {
      const int row = e & (tr - 1);
      const int k = e >> log_tr;
      const int j = static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - log_n));
      F::store(P.out, static_cast<size_t>(k) * P.rows + r0 + row, buf[(row << log_n) + j]);
    } else {
      F::store(P.out, (static_cast<size_t>(r0) << log_n) + e, buf[e]);
    }
  }
}

template <class F>
int launch(const Pass<F>& P, int threads, cudaStream_t stream) {
  const size_t smem = sizeof(typename F::E) << (P.log_n + P.log_tr);
  cudaError_t e = cudaFuncSetAttribute(dif_rows_wide_kernel<F>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dif_rows_wide_kernel<F><<<P.rows >> P.log_tr, threads, smem, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <class F>
Pass<F> make_pass(const void* x, const void* factor, const void* tw, void* out, int rows,
                  int log_n, int tr, int tin, int tout) {
  Pass<F> P;
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

}  // namespace

extern "C" {

// Launches the pass on `stream` without synchronising. kind: 0 goldilocks,
// 1 an 8-limb field, whose {p[8], one[8], inv32, b3} host array is `consts`
// (null for goldilocks). Device pointers: x, out with rows * 2^log_n
// elements (2 or 8 words each) in their layouts, factor likewise or null,
// tw (log_n, 2^log_n) elements. tr (a power of two dividing rows) rows a
// block, `threads` a block (at most 256). Returns the launch's cudaError_t
// (0 on success).
int icicle_ntt_dif_rows_wide(int kind, const void* x, const void* factor, const void* tw,
                             void* out, int rows, int log_n, int tr, int threads,
                             int transpose_in, int transpose_out, const unsigned int* consts,
                             void* stream) {
  if (rows < 1 || tr < 1 || (tr & (tr - 1)) != 0 || rows % tr != 0 || log_n < 1 ||
      threads < 1 || threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    if (log_n > 14) return static_cast<int>(cudaErrorInvalidValue);
    return launch(make_pass<Gl64>(x, factor, tw, out, rows, log_n, tr, transpose_in,
                                  transpose_out), threads, s);
  }
  if (kind == 1 && consts != nullptr) {
    if (log_n > 12) return static_cast<int>(cudaErrorInvalidValue);
    Pass<Fp8> P = make_pass<Fp8>(x, factor, tw, out, rows, log_n, tr, transpose_in,
                                 transpose_out);
    P.c = icicle_ec::consts_from<8>(consts);
    return launch(P, threads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
