// The Z_3329 ring operations of ML-KEM (FIPS 203) on NVIDIA Hopper
// (sm_90a), batched over polynomials. Bound to Python with ctypes
// (icicle_tpu_torch/kernels/mlkem_kernel.py: mlkem_ntt, mlkem_intt,
// mlkem_multiply_ntts).
//
// Replaces no Pallas kernel: the JAX package computes these in XLA,
//   icicle_tpu/ops/pqc/ml_kem_tpu.py:141  ntt (FIPS 203 Alg 9),
//   icicle_tpu/ops/pqc/ml_kem_tpu.py:153  intt (Alg 10, then 3303 = 128^-1),
//   icicle_tpu/ops/pqc/ml_kem_tpu.py:165  multiply_ntts (Algs 11-12),
// and this kernel computes the same functions on (rows, 256) int32
// coefficients in [0, 3329), with canonical outputs, so bit for bit:
//   op 0  ntt: layers of half-length 128 .. 2, layer with nb = 128 / len
//         groups using zetas[nb + group] (17^bitrev7(i) mod q), t = z hi,
//         (lo + t, lo - t);
//   op 1  intt: half-length 2 .. 128, zetas[2 nb - 1 - group],
//         (lo + hi, z (hi - lo)), then x 3303;
//   op 2  multiply_ntts of f and g: pair i, (f0 g0 + (f1 g1 mod q)
//         gamma_i, f0 g1 + f1 g0) with gamma_i = 17^(2 bitrev7(i) + 1).
// Every product is below 3329^2 < 2^24, so int32 holds it before `%`.
//
// Bound: bytes (a polynomial is 1 KB read, 1 KB written; about a thousand
// small multiplies and modular reductions).
//
// Design: one 128-thread block a polynomial, one butterfly (or one pair) a
// thread, the polynomial in shared memory between layers; zetas and gammas
// in constant memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQ = 3329;
constexpr int kN = 256;
constexpr int kThreads = kN / 2;

__constant__ int32_t kZetas[128] = {
    1,    1729, 2580, 3289, 2642, 630,  1897, 848,  1062, 1919, 193,  797,  2786, 3260, 569,
    1746, 296,  2447, 1339, 1476, 3046, 56,   2240, 1333, 1426, 2094, 535,  2882, 2393, 2879,
    1974, 821,  289,  331,  3253, 1756, 1197, 2304, 2277, 2055, 650,  1977, 2513, 632,  2865,
    33,   1320, 1915, 2319, 1435, 807,  452,  1438, 2868, 1534, 2402, 2647, 2617, 1481, 648,
    2474, 3110, 1227, 910,  17,   2761, 583,  2649, 1637, 723,  2288, 1100, 1409, 2662, 3281,
    233,  756,  2156, 3015, 3050, 1703, 1651, 2789, 1789, 1847, 952,  1461, 2687, 939,  2308,
    2437, 2388, 733,  2337, 268,  641,  1584, 2298, 2037, 3220, 375,  2549, 2090, 1645, 1063,
    319,  2773, 757,  2099, 561,  2466, 2594, 2804, 1092, 403,  1026, 1143, 2150, 2775, 886,
    1722, 1212, 1874, 1029, 2110, 2935, 885,  2154};

__constant__ int32_t kGammas[128] = {
    17,   3312, 2761, 568,  583,  2746, 2649, 680,  1637, 1692, 723,  2606, 2288, 1041, 1100,
    2229, 1409, 1920, 2662, 667,  3281, 48,   233,  3096, 756,  2573, 2156, 1173, 3015, 314,
    3050, 279,  1703, 1626, 1651, 1678, 2789, 540,  1789, 1540, 1847, 1482, 952,  2377, 1461,
    1868, 2687, 642,  939,  2390, 2308, 1021, 2437, 892,  2388, 941,  733,  2596, 2337, 992,
    268,  3061, 641,  2688, 1584, 1745, 2298, 1031, 2037, 1292, 3220, 109,  375,  2954, 2549,
    780,  2090, 1239, 1645, 1684, 1063, 2266, 319,  3010, 2773, 556,  757,  2572, 2099, 1230,
    561,  2768, 2466, 863,  2594, 735,  2804, 525,  1092, 2237, 403,  2926, 1026, 2303, 1143,
    2186, 2150, 1179, 2775, 554,  886,  2443, 1722, 1607, 1212, 2117, 1874, 1455, 1029, 2300,
    2110, 1219, 2935, 394,  885,  2444, 2154, 1175};

__global__ void __launch_bounds__(kThreads)
mlkem_kernel(int op, const int32_t* __restrict__ f, const int32_t* __restrict__ g,
             int32_t* __restrict__ out) {
  __shared__ int32_t s[kN];
  const long long base = static_cast<long long>(blockIdx.x) * kN;
  const int t = threadIdx.x;
  if (op == 2) {
    const int32_t f0 = f[base + 2 * t], f1 = f[base + 2 * t + 1];
    const int32_t g0 = g[base + 2 * t], g1 = g[base + 2 * t + 1];
    out[base + 2 * t] = (f0 * g0 + (f1 * g1 % kQ) * kGammas[t]) % kQ;
    out[base + 2 * t + 1] = (f0 * g1 + f1 * g0) % kQ;
    return;
  }
  s[t] = f[base + t];
  s[t + kThreads] = f[base + t + kThreads];
  __syncthreads();
  if (op == 0) {
#pragma unroll
    for (int len = 128; len >= 2; len >>= 1) {
      const int nb = kN / (2 * len);
      const int grp = t / len, j = t % len;
      const int i = grp * 2 * len + j;
      const int32_t lo = s[i];
      const int32_t tt = kZetas[nb + grp] * s[i + len] % kQ;
      s[i] = (lo + tt) % kQ;
      s[i + len] = (lo - tt + kQ) % kQ;
      __syncthreads();
    }
    out[base + t] = s[t];
    out[base + t + kThreads] = s[t + kThreads];
  } else {
#pragma unroll
    for (int len = 2; len <= 128; len <<= 1) {
      const int nb = kN / (2 * len);
      const int grp = t / len, j = t % len;
      const int i = grp * 2 * len + j;
      const int32_t lo = s[i], hi = s[i + len];
      s[i] = (lo + hi) % kQ;
      s[i + len] = kZetas[2 * nb - 1 - grp] * (hi - lo + kQ) % kQ;
      __syncthreads();
    }
    out[base + t] = s[t] * 3303 % kQ;
    out[base + t + kThreads] = s[t + kThreads] * 3303 % kQ;
  }
}

}  // namespace

extern "C" {

// Runs op (0 ntt, 1 intt, 2 multiply_ntts of f and g) over `rows`
// polynomials on `stream` without synchronising. f, g, out: device
// pointers to (rows, 256) int32 (g read by op 2 only). Returns the
// launch's cudaError_t (0 on success).
int icicle_mlkem(int op, const void* f, const void* g, void* out, long long rows, void* stream) {
  if (rows < 1 || rows > 0x7FFFFFFFLL || op < 0 || op > 2 || (op == 2 && g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  mlkem_kernel<<<static_cast<unsigned int>(rows), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(op, static_cast<const int32_t*>(f),
                                                      static_cast<const int32_t*>(g),
                                                      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* icicle_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
