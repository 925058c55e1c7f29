// Batched BLAKE3 (default mode, 32-byte digests) on NVIDIA Hopper (sm_90a).
// Bound to Python with ctypes (icicle_tpu_torch/kernels/blake3_kernel.py:
// blake3).
//
// No Pallas kernel is replaced: the JAX package computes the compression as
// XLA (icicle_tpu/ops/hash/blake3.py:64 _compress_dyn, driven by
// Blake3._run :132 from hash_words :231 and hash_bytes :214), vectorised
// over the batch and the chunks. Input: (batch, in_words) uint32
// little-endian words of messages of nbytes bytes (in_words =
// ceil(nbytes / 4)); words past in_words read as zero, with no padded copy
// in memory. Output: (batch, 8) uint32 digests. A compression is 7 rounds,
// the message permutation between rounds as compile-time register renaming;
// its chaining value is v[i] ^ v[i + 8], i < 8.
//
// Two regimes, as the JAX package's:
//   nbytes <= 1024, one chunk: `chunks` with one thread a row, over its
//     ceil(nbytes / 64) blocks (at least one) in turn: counter 0,
//     CHUNK_START on block 0, CHUNK_END | ROOT on the last, whose length is
//     the bytes that remain (nbytes = 0: one block of length 0). Every
//     Merkle layer over 32- or 64-byte rows is this regime, one compression
//     a row, one launch.
//   nbytes > 1024: `chunks` with one thread a (row, chunk), counter = the
//     chunk's index, no ROOT, into a (batch, chunks, 8) array of chaining
//     values; then `parents`, one launch a level: adjacent values paired
//     left to right, an odd last one carried up a level, flags PARENT (and
//     ROOT on the final merge), block length 64, counter 0 (JAX :194-210).
//     An 8 KiB message is one chunk pass and three parent levels.
//
// Bound: integer instructions, as blake2s.cu's: a compression is 7 rounds
// of 8 G's of 12 instructions (blake.cuh) plus 8 XORs for the output: 680
// (blake3_kernel.COMPRESS_OPS), of which 224 adds may issue on the FMA pipe
// and 456 need the ALU pipe. Bytes: each row read once and its digest
// written once.

#include <cstdint>
#include <cuda_runtime.h>

#include "blake.cuh"
#include "mont32.cuh"  // icicle_error_string

namespace {

using namespace icicle_blake;

constexpr int kThreads = 128;
constexpr uint32_t kChunkStart = 1, kChunkEnd = 2, kParent = 4, kRoot = 8;
constexpr long long kChunkBytes = 1024;

// cv <- the chaining value of compressing block m into cv.
__device__ __forceinline__ void compress(uint32_t (&cv)[8], const uint32_t (&m)[16],
                                         uint32_t counter, uint32_t block_len, uint32_t flags) {
  constexpr uint32_t kIV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                               0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  constexpr int kPerm[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};
  uint32_t v[16] = {cv[0],  cv[1],  cv[2],  cv[3], cv[4],   cv[5], cv[6],     cv[7],
                    kIV[0], kIV[1], kIV[2], kIV[3], counter, 0u,   block_len, flags};
  uint32_t mr[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) mr[j] = m[j];
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    mix_round(v, mr);
    uint32_t next[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) next[j] = mr[kPerm[j]];
#pragma unroll
    for (int j = 0; j < 16; ++j) mr[j] = next[j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) cv[i] = v[i] ^ v[i + 8];
}

// One thread a (row, chunk) of `chunks` chunks: the chunk's chaining value
// to out[(row, chunk)]; `root`: the message is one chunk (ROOT on its last
// block, and out is the digest).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    blake3_chunks(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long batch,
                  int in_words, long long nbytes, int chunks, int root) {
  const long long id = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (id >= batch * chunks) return;
  const long long row = chunks == 1 ? id : id / chunks;  // a Merkle layer divides by nothing
  const long long ci = id - row * chunks;
  const uint32_t* x = in + row * in_words;
  const long long cbytes = min(kChunkBytes, nbytes - ci * kChunkBytes);
  const int nb = cbytes > 64 ? static_cast<int>((cbytes + 63) / 64) : 1;
  uint32_t cv[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  for (int b = 0; b < nb; ++b) {
    uint32_t m[16];
    load_block<kVec>(m, x, ci * (kChunkBytes / 4) + b * 16, in_words);
    const long long left = cbytes - 64LL * b;
    const uint32_t len = static_cast<uint32_t>(left < 64 ? (left > 0 ? left : 0) : 64);
    uint32_t flags = b == 0 ? kChunkStart : 0u;
    if (b == nb - 1) flags |= kChunkEnd | (root ? kRoot : 0u);
    compress(cv, m, static_cast<uint32_t>(ci), len, flags);
  }
  store8(out + id * 8, cv);
}

// One level of parent merges: in (batch, num, 8) chaining values ->
// out (batch, ceil(num / 2), 8); `root`: num == 2, the final merge.
__global__ void __launch_bounds__(kThreads)
    blake3_parents(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, long long batch,
                   int num, int root) {
  const int nout = (num + 1) / 2;
  const long long id = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (id >= batch * nout) return;
  const long long row = id / nout;
  const long long j = id - row * nout;
  const uint32_t* src = in + (row * num + 2 * j) * 8;  // left then right: 16 words
  uint32_t cv[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};
  if (2 * j + 1 < num) {
    uint32_t m[16];
    load_block<true>(m, src, 0, 16);
    compress(cv, m, 0u, 64u, kParent | (root ? kRoot : 0u));
  } else {
    uint32_t m[16];
    load_block<true>(m, src, 0, 8);  // the odd one out, carried up a level
#pragma unroll
    for (int i = 0; i < 8; ++i) cv[i] = m[i];
  }
  store8(out + id * 8, cv);
}

cudaError_t grid(long long threads, unsigned* blocks) {
  const long long b = (threads + kThreads - 1) / kThreads;
  if (b > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(b);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The chunk pass of `batch` rows of in_words words, messages of nbytes
// bytes (in_words = ceil(nbytes / 4)), on `stream` without synchronising:
// out (batch, chunks, 8), chunks = max(1, ceil(nbytes / 1024)); with one
// chunk it is the digest (ROOT). in, out: device pointers, out 32-byte
// aligned. vec: 1 when in is 16-byte aligned and in_words a multiple of 4.
// Returns the launch's cudaError_t (0 on success).
int icicle_blake3_chunks(const void* in, void* out, long long batch, int in_words,
                         long long nbytes, int vec, void* stream) {
  if (batch < 1 || in_words < 0 || (nbytes + 3) / 4 != in_words)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = nbytes > kChunkBytes ? (nbytes + kChunkBytes - 1) / kChunkBytes : 1;
  unsigned blocks = 0;
  if (chunks > 0x7FFFFFFFLL || grid(batch * chunks, &blocks) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint32_t*>(in);
  auto* y = static_cast<uint32_t*>(out);
  const int c = static_cast<int>(chunks), root = chunks == 1 ? 1 : 0;
  if (vec)
    blake3_chunks<true><<<blocks, kThreads, 0, s>>>(x, y, batch, in_words, nbytes, c, root);
  else
    blake3_chunks<false><<<blocks, kThreads, 0, s>>>(x, y, batch, in_words, nbytes, c, root);
  return static_cast<int>(cudaGetLastError());
}

// One parent level: in (batch, num, 8) -> out (batch, ceil(num / 2), 8),
// num >= 2, ROOT when num == 2. in, out: 32-byte aligned device pointers.
// Returns the launch's cudaError_t (0 on success).
int icicle_blake3_parents(const void* in, void* out, long long batch, int num, void* stream) {
  unsigned blocks = 0;
  if (batch < 1 || num < 2 || grid(batch * ((num + 1) / 2), &blocks) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidValue);
  blake3_parents<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), batch, num,
      num == 2 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
