// The negacyclic NTT of R_q = Z_q[X]/(X^64 + 1) on NVIDIA Hopper (sm_90a),
// batched over polynomials. Bound to Python with ctypes
// (icicle_tpu_torch/kernels/rq_ntt_kernel.py: rq_ntt).
//
// Replaces no Pallas kernel: the JAX package computes the negacyclic NTT
// as its generic NTT over the ring in XLA (icicle_tpu/rings/rq.py:33
// negacyclic_ntt: coset psi = omega(128), ordering NR forward, RN
// inverse), and this kernel computes the same function:
//   forward  a_j = x_j psi^j, then a decimation-in-frequency transform with
//            w = psi^2 (natural in, bit-reversed out: NR);
//   inverse  a decimation-in-time transform with w^-1 (bit-reversed in,
//            natural out: RN), then a_j n^-1 psi^-j.
// x, out: (rows, 64, 2) uint32, the [lo, hi] words of canonical Z_q values
// (q = P_bb P_kb < 2^62), read and written as one uint64 a coefficient.
// Every step is canonical modular arithmetic, so the result equals the
// plain version's (the port's generic NTT over Z_q) bit for bit.
//
// Arithmetic: 64-bit Montgomery with R = 2^64 for an odd q < 2^62: a b as
// a 128-bit product (a mul and a __umul64hi), m = lo q' mod 2^64,
// (a b + m q) / 2^64 = hi + umulhi(m, q) + (lo != 0) < 2q, one conditional
// subtract. The twiddles are Montgomery forms, so a product with one is
// the plain product. Table (192 words, built by the wrapper): twist[64],
// fwd[32], inv[32], untwist[64].
//
// Bound: bytes. A polynomial is 512 bytes read and 512 written against
// 64 + 6 x 32 = 256 Montgomery multiplies of 11 32-bit products.
//
// Design: one warp a polynomial, one butterfly a thread a stage, the 64
// coefficients in shared memory between stages (__syncwarp), the table
// in shared memory once a block; eight polynomials a 256-thread block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 64;
constexpr int kLog = 6;
constexpr int kPolys = 8;          // polynomials (warps) a block
constexpr int kThreads = 32 * kPolys;
constexpr int kTableWords = 3 * kN;
constexpr int kTwist = 0, kFwd = kN, kInv = kN + kN / 2, kUntwist = 2 * kN;

__device__ __forceinline__ uint64_t mont_mul(uint64_t a, uint64_t b, uint64_t q, uint64_t qinv) {
  const uint64_t lo = a * b;
  const uint64_t hi = __umul64hi(a, b);
  const uint64_t m = lo * qinv;
  const uint64_t r = hi + __umul64hi(m, q) + (lo != 0 ? 1 : 0);
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint64_t add_mod(uint64_t a, uint64_t b, uint64_t q) {
  const uint64_t s = a + b;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint64_t sub_mod(uint64_t a, uint64_t b, uint64_t q) {
  return a >= b ? a - b : a + q - b;
}

__global__ void __launch_bounds__(kThreads)
rq_ntt_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
              const uint64_t* __restrict__ table, long long rows, int inverse, uint64_t q,
              uint64_t qinv) {
  __shared__ uint64_t tw[kTableWords];
  __shared__ uint64_t a[kPolys][kN];
  for (int i = threadIdx.x; i < kTableWords; i += kThreads) tw[i] = table[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const long long poly = static_cast<long long>(blockIdx.x) * kPolys + warp;
  if (poly >= rows) return;
  const uint64_t* src = x + poly * kN;
  uint64_t* s = a[warp];
  if (!inverse) {
    s[t] = mont_mul(src[t], tw[kTwist + t], q, qinv);
    s[t + 32] = mont_mul(src[t + 32], tw[kTwist + t + 32], q, qinv);
    __syncwarp();
#pragma unroll
    for (int lg = kLog - 1; lg >= 0; --lg) {  // half-block 32 .. 1
      const int len = 1 << lg;
      const int j = t & (len - 1);
      const int i = (t - j) * 2 + j;
      const uint64_t u = s[i], v = s[i + len];
      s[i] = add_mod(u, v, q);
      s[i + len] = mont_mul(sub_mod(u, v, q), tw[kFwd + (j << (kLog - 1 - lg))], q, qinv);
      __syncwarp();
    }
    out[poly * kN + t] = s[t];
    out[poly * kN + t + 32] = s[t + 32];
  } else {
    s[t] = src[t];
    s[t + 32] = src[t + 32];
    __syncwarp();
#pragma unroll
    for (int lg = 0; lg < kLog; ++lg) {  // half-block 1 .. 32
      const int len = 1 << lg;
      const int j = t & (len - 1);
      const int i = (t - j) * 2 + j;
      const uint64_t u = s[i];
      const uint64_t v = mont_mul(s[i + len], tw[kInv + (j << (kLog - 1 - lg))], q, qinv);
      s[i] = add_mod(u, v, q);
      s[i + len] = sub_mod(u, v, q);
      __syncwarp();
    }
    out[poly * kN + t] = mont_mul(s[t], tw[kUntwist + t], q, qinv);
    out[poly * kN + t + 32] = mont_mul(s[t + 32], tw[kUntwist + t + 32], q, qinv);
  }
}

}  // namespace

extern "C" {

// Transforms `rows` polynomials on `stream` without synchronising. x, out:
// device pointers to (rows, 64, 2) uint32 (8-byte aligned); table: device
// pointer to the 192 Montgomery-form words; inverse: 0 forward, 1 inverse;
// q odd below 2^62, qinv = -q^-1 mod 2^64. Returns the launch's
// cudaError_t (0 on success).
int icicle_rq_ntt(const void* x, void* out, const void* table, long long rows, int inverse,
                  unsigned long long q, unsigned long long qinv, void* stream) {
  if (rows < 1 || (q & 1) == 0 || q >= (1ULL << 62) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + kPolys - 1) / kPolys;
  rq_ntt_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(x), static_cast<uint64_t*>(out),
      static_cast<const uint64_t*>(table), rows, inverse, q, qinv);
  return static_cast<int>(cudaGetLastError());
}

const char* icicle_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
