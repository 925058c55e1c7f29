// Batched BLAKE2s-256 on NVIDIA Hopper (sm_90a). Bound to Python with
// ctypes (icicle_tpu_torch/kernels/blake2s_kernel.py: blake2s).
//
// No Pallas kernel is replaced: the JAX package computes the compression as
// XLA (icicle_tpu/ops/hash/blake2s.py:47 _compress, driven by Blake2s._run
// :82 from hash_words :108 and hash_bytes :94), vectorised over the batch,
// its ten rounds under lax.scan. Here one thread hashes one row:
//   in   (batch, in_words) uint32 little-endian words of a message of
//        nbytes bytes (in_words = ceil(nbytes / 4)); words past in_words
//        read as zero, with no padded copy in memory;
//   out  (batch, 8) uint32: the 32-byte digest.
// h = IV with h0 ^= 0x01010020 (depth 1, fanout 1, 32-byte digest, no key);
// blocks = max(1, ceil(nbytes / 64)), so nbytes = 0 is one zero block with
// t = 0. Block i's byte counter t is min(nbytes, 64 (i + 1)), in v[12] and
// v[13] (its high word, 0 here); the last block's is nbytes, with v[14]
// inverted. The 16 message words and the 16 state words stay in registers;
// the ten rounds are unrolled, with SIGMA as compile-time indices, so the
// message permutation costs nothing. A 64-byte row (a Merkle compress
// layer) is four 16-byte loads (blake.cuh load_block) where the rows are
// aligned, and the digest two 16-byte stores.
//
// Bound: integer instructions. A compression is 10 rounds of 8 G's of 12
// instructions (blake.cuh) plus 8 three-input XORs for the output and 2 for
// the counter and the final flag: 970 (blake2s_kernel.COMPRESS_OPS). Its
// 320 adds may issue on the FMA pipe (ptxas makes about half of them
// IMAD.IADD); the other 650 need the ALU pipe, 64 lanes a clock an SM,
// and all 970 the four schedulers, 128 lanes a clock an SM, at 132 SMs x
// the SM clock. Bytes: each row read once and its digest written once.

#include <cstdint>
#include <cuda_runtime.h>

#include "blake.cuh"
#include "mont32.cuh"  // icicle_error_string

namespace {

using namespace icicle_blake;

constexpr int kThreads = 128;

// h <- the compression of block m into h; t: the byte counter; last: the
// final block.
__device__ __forceinline__ void compress(uint32_t (&h)[8], const uint32_t (&m)[16],
                                         uint64_t t, bool last) {
  constexpr uint32_t kIV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                               0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  constexpr int kSigma[10][16] = {
      {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
      {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
      {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
      {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
      {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
      {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
      {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
      {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
      {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
      {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};
  uint32_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = kIV[i];
  }
  v[12] ^= static_cast<uint32_t>(t);
  v[13] ^= static_cast<uint32_t>(t >> 32);
  if (last) v[14] = ~v[14];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t mr[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) mr[j] = m[kSigma[r][j]];
    mix_round(v, mr);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    blake2s_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long batch,
                   int in_words, long long nbytes) {
  const long long row = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (row >= batch) return;
  const uint32_t* x = in + row * in_words;
  // the IV, with h0 ^= 0x01010020
  uint32_t h[8] = {0x6A09E667u ^ 0x01010020u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                   0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  const long long blocks = nbytes > 64 ? (nbytes + 63) / 64 : 1;
  for (long long blk = 0; blk < blocks; ++blk) {
    uint32_t m[16];
    load_block<kVec>(m, x, blk * 16, in_words);
    const bool last = blk == blocks - 1;
    const uint64_t t = last ? nbytes : min(nbytes, 64 * (blk + 1));
    compress(h, m, t, last);
  }
  store8(out + row * 8, h);
}

}  // namespace

extern "C" {

// Hashes `batch` rows of in_words words, messages of nbytes bytes
// (in_words = ceil(nbytes / 4)), on `stream` without synchronising. in,
// out: device pointers, out 32-byte aligned. vec: 1 when in is 16-byte
// aligned and in_words a multiple of 4. Returns the launch's cudaError_t
// (0 on success).
int icicle_blake2s(const void* in, void* out, long long batch, int in_words, long long nbytes,
                   int vec, void* stream) {
  if (batch < 1 || in_words < 0 || (nbytes + 3) / 4 != in_words)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (batch + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(in);
  auto* y = static_cast<uint32_t*>(out);
  if (vec)
    blake2s_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(x, y, batch,
                                                                             in_words, nbytes);
  else
    blake2s_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(x, y, batch,
                                                                              in_words, nbytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
