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
// out[r, :] = all log_n DIF stages of (x[r, :] (* factor[r, :])): natural
// order in, bit-reversed order out. Stage s, half-block m = N >> (s+1),
// butterfly on (i0, i1 = i0 + m):
//   out[i0] = x[i0] + x[i1]
//   out[i1] = mont(x[i0] - x[i1], tw[s, i1]),  tw[s, i] = w^((i & (m-1)) << s) R
// exactly the Pallas stage (ntt_kernel.py:97-106). Inputs must be canonical
// (< p < 2^31); the wrapper checks p, dtype and shapes, not the values.
//
// Design: one block per row. The row (N * 4 bytes: 32 KB at N = 2^13, 64 KB
// at N = 2^14) is loaded coalesced into dynamic shared memory, multiplied by
// `factor` on the way in when given, put through all log_n stages with a
// barrier between stages, and stored coalesced. Twiddles come from the
// (log_n, N) stage table in device memory: within a stage, neighbouring
// threads read neighbouring entries, and the table (416 KB at N = 2^13)
// stays in L2.
//
// Bound: each element is read once and written once, so a pass moves
// rows * N * 4 * 2 bytes (* 3 with `factor`) at 3.35 TB/s; against that,
// (log_n * N/2 + N with factor) Montgomery multiplies of three 32-bit
// integer multiplies each at the integer rate. At the 2^26 NTT's shape
// (8192 rows of 2^13) the bytes bound: 0.16 ms per pass, 0.24 ms with the
// factor. chip_smoke.py computes both bounds from each run's shapes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t p, uint32_t inv32) {
  // t < p^2 < 2^62 and m * p < 2^63: the sum cannot overflow 64 bits.
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(t) * inv32;  // -t / p mod 2^32
  const uint32_t u =
      static_cast<uint32_t>((t + static_cast<uint64_t>(m) * p) >> 32);
  return u >= p ? u - p : u;  // u < 2p
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;  // < 2p < 2^32
  return s >= p ? s - p : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  return a >= b ? a - b : a + p - b;
}

template <bool kFactor>
__global__ void dif_rows_kernel(const uint32_t* __restrict__ x,
                                const uint32_t* __restrict__ factor,
                                const uint32_t* __restrict__ tw,
                                uint32_t* __restrict__ out,
                                int log_n, uint32_t p, uint32_t inv32) {
  extern __shared__ uint32_t row[];
  const int n = 1 << log_n;
  const size_t base = static_cast<size_t>(blockIdx.x) << log_n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t v = x[base + i];
    if constexpr (kFactor) v = mont_mul(v, factor[base + i], p, inv32);
    row[i] = v;
  }
  __syncthreads();

  for (int s = 0; s < log_n; ++s) {
    const int log_m = log_n - 1 - s;
    const int m = 1 << log_m;
    const uint32_t* tws = tw + (static_cast<size_t>(s) << log_n);
    for (int b = threadIdx.x; b < n / 2; b += blockDim.x) {
      const int i0 = ((b >> log_m) << (log_m + 1)) | (b & (m - 1));
      const int i1 = i0 + m;
      const uint32_t top = row[i0];
      const uint32_t bot = row[i1];
      row[i0] = add_mod(top, bot, p);
      row[i1] = mont_mul(sub_mod(top, bot, p), tws[i1], p, inv32);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) out[base + i] = row[i];
}

template <bool kFactor>
cudaError_t launch(const uint32_t* x, const uint32_t* factor, const uint32_t* tw,
                   uint32_t* out, int rows, int log_n, uint32_t p,
                   uint32_t inv32, cudaStream_t stream) {
  const int n = 1 << log_n;
  const size_t smem = sizeof(uint32_t) * n;
  if (smem > 48 * 1024) {
    // above 48 KB a block gets dynamic shared memory only on request
    const cudaError_t e = cudaFuncSetAttribute(
        dif_rows_kernel<kFactor>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = n / 2 < 512 ? n / 2 : 512;
  dif_rows_kernel<kFactor><<<rows, threads, smem, stream>>>(
      x, factor, tw, out, log_n, p, inv32);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the pass on `stream` without synchronising. All pointers are
// device pointers: x, out (rows, 2^log_n); factor (rows, 2^log_n) or null;
// tw (log_n, 2^log_n). Returns the launch's cudaError_t (0 on success).
int icicle_ntt_dif_rows(const void* x, const void* factor, const void* tw,
                        void* out, int rows, int log_n, unsigned int p,
                        unsigned int inv32, void* stream) {
  const auto* xs = static_cast<const uint32_t*>(x);
  const auto* fs = static_cast<const uint32_t*>(factor);
  const auto* ts = static_cast<const uint32_t*>(tw);
  auto* os = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      fs ? launch<true>(xs, fs, ts, os, rows, log_n, p, inv32, st)
         : launch<false>(xs, nullptr, ts, os, rows, log_n, p, inv32, st);
  return static_cast<int>(e);
}

const char* icicle_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
