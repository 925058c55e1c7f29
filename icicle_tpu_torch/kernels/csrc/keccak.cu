// Batched Keccak / SHA-3 on NVIDIA Hopper (sm_90a): kernel K1 of the port.
// Bound to Python with ctypes (icicle_tpu_torch/kernels/keccak_kernel.py:
// keccak).
//
// No Pallas kernel is replaced: the JAX package computes the sponge as XLA
// (icicle_tpu/ops/hash/keccak.py:90 keccak_f1600, :108 _absorb_padded,
// :148 hash_words) over (lo, hi) uint32 lane pairs, the TPU having no
// 64-bit integers. Here one thread hashes one row with the 25 lanes in
// uint64 registers:
//   in   (batch, in_words) uint32 words; word 2w is the low half of lane w;
//   pad  in registers, with no padded copy in memory (hash_words' layout,
//        keccak.py:151-160): nof_blocks = in_words / rate_words + 1 blocks
//        of rate_words words, the pad byte (0x01 Keccak, 0x06 SHA-3) in
//        word in_words and 0x80 in the top byte of the last word; an input
//        of exactly one rate of words takes two blocks. The `padded`
//        entry takes rows the host padded (hash_bytes, any byte length);
//   out  (batch, digest_words): the low and high halves of lanes
//        0..digest_words/2 - 1.
// One instance per (rate, pad byte, digest words, padded): Keccak-256 and
// SHA3-256 (rate 136 bytes, 8 words), Keccak-512 and SHA3-512 (rate 72,
// 16 words). The 24 rounds are unrolled: rotation offsets and round
// constants are compile-time, each 64-bit rotation two funnel shifts
// (SHF), chi's a ^ (~b & c) one three-input logic instruction (LOP3) a
// half; a rotation by 0 is none.
//
// Bound: operations on the ALU pipe. A permutation needs 4,309 32-bit
// logic and shift instructions (keccak_kernel.PERMUTATION_OPS, counted
// from the spec), 1 permutation a row of one block: at the FRI round-0
// leaf layer (2^22 rows of 1 word) that is 1.8e10 instructions, 1.08 ms at
// 64 lanes a clock an SM x 132 SMs x 1.98 GHz, against 48 MB of bytes
// (14 us).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint64_t rotl(uint64_t x, int n) {
  return n == 0 ? x : (x << n) | (x >> (64 - n));
}

__device__ __forceinline__ void keccak_f(uint64_t (&s)[25]) {
  // rho offsets r[x + 5y] and round constants (the Keccak reference)
  constexpr int kRot[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                            25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  constexpr uint64_t kRC[24] = {
      0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
      0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
      0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
      0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
      0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
      0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
      0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
      0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};
#pragma unroll
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; ++y)  // theta, then rho and pi
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(s[x + 5 * y] ^ d, kRot[x + 5 * y]);
    }
#pragma unroll
    for (int y = 0; y < 5; ++y)
#pragma unroll
      for (int x = 0; x < 5; ++x)  // chi
        s[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    s[0] ^= kRC[round];
  }
}

// RATE words a block (34 or 18), PAD the domain byte, DW digest words;
// PADDED: the rows are whole padded blocks (in_words = blocks RATE).
template <int RATE, uint32_t PAD, int DW, bool PADDED>
__global__ void __launch_bounds__(kThreads)
    keccak_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long batch,
                  int in_words) {
  const long long row = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (row >= batch) return;
  const uint32_t* x = in + row * in_words;
  const int blocks = PADDED ? in_words / RATE : in_words / RATE + 1;
  const int last = blocks * RATE - 1;
  uint64_t s[25];
#pragma unroll
  for (int w = 0; w < 25; ++w) s[w] = 0;
  for (int blk = 0; blk < blocks; ++blk) {
    const int base = blk * RATE;
#pragma unroll
    for (int w = 0; w < RATE / 2; ++w) {
      uint32_t half[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = base + 2 * w + j;
        uint32_t v = k < in_words ? __ldg(x + k) : 0u;
        if (!PADDED) {
          if (k == in_words) v |= PAD;
          if (k == last) v |= 0x80000000u;
        }
        half[j] = v;
      }
      s[w] ^= (static_cast<uint64_t>(half[1]) << 32) | half[0];
    }
    keccak_f(s);
  }
  uint32_t* o = out + row * DW;
#pragma unroll
  for (int w = 0; w < DW / 2; ++w) {
    o[2 * w] = static_cast<uint32_t>(s[w]);
    o[2 * w + 1] = static_cast<uint32_t>(s[w] >> 32);
  }
}

template <int RATE, uint32_t PAD, int DW>
cudaError_t launch(const void* in, void* out, long long batch, int in_words, int padded,
                   cudaStream_t s) {
  const unsigned int blocks = static_cast<unsigned int>((batch + kThreads - 1) / kThreads);
  const auto* x = static_cast<const uint32_t*>(in);
  auto* y = static_cast<uint32_t*>(out);
  if (padded)
    keccak_kernel<RATE, PAD, DW, true><<<blocks, kThreads, 0, s>>>(x, y, batch, in_words);
  else
    keccak_kernel<RATE, PAD, DW, false><<<blocks, kThreads, 0, s>>>(x, y, batch, in_words);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Hashes `batch` rows of in_words words on `stream` without synchronising.
// rate_bytes: 136 or 72; pad: 0x01 (Keccak) or 0x06 (SHA-3); digest_words:
// 8 at rate 136, 16 at rate 72; padded: 1 when the rows are whole padded
// blocks (in_words a multiple of the rate's words). in, out: device
// pointers. Returns the launch's cudaError_t (0 on success).
int icicle_keccak(const void* in, void* out, long long batch, int in_words, int rate_bytes,
                  int pad, int digest_words, int padded, void* stream) {
  if (batch < 1 || in_words < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (padded && (in_words == 0 || in_words % (rate_bytes / 4) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rate_bytes == 136 && digest_words == 8 && pad == 0x01)
    return static_cast<int>(launch<34, 0x01u, 8>(in, out, batch, in_words, padded, s));
  if (rate_bytes == 136 && digest_words == 8 && pad == 0x06)
    return static_cast<int>(launch<34, 0x06u, 8>(in, out, batch, in_words, padded, s));
  if (rate_bytes == 72 && digest_words == 16 && pad == 0x01)
    return static_cast<int>(launch<18, 0x01u, 16>(in, out, batch, in_words, padded, s));
  if (rate_bytes == 72 && digest_words == 16 && pad == 0x06)
    return static_cast<int>(launch<18, 0x06u, 16>(in, out, batch, in_words, padded, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* icicle_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
