// Batched Poseidon hash on NVIDIA Hopper (sm_90a), one thread per hash:
// the code shared by the single-word instances (poseidon.cu) and the
// 8-limb ones (poseidon_limbs.cu), two libraries that build in parallel.
// Bound to Python with ctypes (icicle_tpu_torch/kernels/poseidon_kernel.py:
// poseidon).
//
// No TPU kernel is replaced: the JAX package computes the permutation as
// XLA (icicle_tpu/ops/hash/poseidon.py:143 permute_mont, jitted through
// _hash_fields_impl :172 and _hash_words_impl :197), which fuses the rounds
// into one program. This kernel is that program for a batch: each thread
// reads its row's inputs (t of them, or t - 1 after a domain tag in lane 0;
// there is no sponge), takes them into Montgomery form, runs the
// permutation and writes lane 1 out of Montgomery form.
//   in  (batch, n) uint32 canonical elements, or (batch, n, 8) limbs;
//   out (batch,) or (batch, 8), canonical.
// The permutation (cpu_poseidon.cpp; the S-box is x^5 for every field):
//   += rc_pre on every lane;
//   (half - 1) full rounds: x^5 on every lane, += rc, x MDS;
//   one full round with the pre-matrix round's constants and pre_matrix;
//   partial rounds: x^5 and += rc on lane 0, then the sparse matrix:
//     out_0 = <s, col0>, out_j = s_0 row0[j - 1] + s_j;
//   (half - 1) full rounds;
//   the last round: x^5 on every lane, x MDS. Only lane 1 of its product is
//   the digest, so the kernel computes that column alone: t multiplies
//   where the plain version's matrix product takes t^2.
// A matrix product is out_c = sum_r s_r M[r, c]. Every value stays
// canonical after every add and multiply, so the order of a sum does not
// change it, and the digest is bit-equal to the plain version and the JAX
// package whatever order they add in.
//
// Constants: one flat table an instance, in Montgomery form: the round
// constants of every round in order (2 half t + partial), MDS (t^2),
// pre_matrix (t^2) and the sparse matrices (partial (2t - 1)); `Layout`
// gives the offsets. Round counts are compile-time (the tables
// POSEIDON_WORDS in poseidon.cu and POSEIDON_LIMBS in poseidon_limbs.cu;
// the C entries refuse a call whose counts differ).
//   Single-word instances (babybear, koalabear, m31; mont32.cuh's
//   arithmetic) keep the state in registers and unroll every round and
//   every matrix product, so each constant is a compile-time offset into
//   the instance's __constant__ table (an operand of the multiply, no load
//   and no address arithmetic), written once per (field, t, device) by
//   icicle_poseidon_upload. The largest, t = 12, is 672 words; all twelve
//   instances take 17 KB of the 64 KB constant bank.
//   8-limb instances (bn254_scalar, grumpkin_scalar, bls12_377_scalar,
//   bls12_381_scalar, stark252; poseidon2.cuh's Limbs8 over ec_field.cuh's
//   Fp<8> and CIOS mont_mul<8>) roll their round, lane and matrix loops up
//   (state in thread-local memory): unrolled, an 8-limb Poseidon2 at t = 8
//   took minutes of ptxas and spilled at 255 registers. They read
//   the table from the device array Poseidon keeps, one uniform load of 8
//   words a constant: a t = 12 table is 1,752 elements (56 KB) and the five
//   instances' tables would not fit the 64 KB constant bank together.
//
// Bound: integer multiplies. A hash needs (full - 1)(3t + t^2) + partial
// (2t + 2) + 4t Montgomery multiplies (poseidon_kernel.needed_monts) and
// n + 1 conversions; at 3 integer multiplies a single-word Montgomery
// multiply and 4 L^2 + L = 264 an 8-limb one. No lazy reduction: every
// product is reduced before the next add (a later PR's work).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "mont32.cuh"
#include "poseidon2.cuh"

namespace icicle_pos {

constexpr int kThreads = 128;

// A single-word field over mont32.cuh in the interface of poseidon2.cuh's
// field types (a run-time context C, empty here).
template <uint32_t P>
struct Word32 {
  using M = icicle_m32::Mont32<P>;
  static constexpr bool kRegisters = true;
  static constexpr int kWords = 1;
  using E = uint32_t;
  struct C {};
  static __device__ __forceinline__ E add(E a, E b, const C&) { return M::add(a, b); }
  static __device__ __forceinline__ E mul(E a, E b, const C&) { return M::mul(a, b); }
  static __device__ __forceinline__ E to_mont(E a, const C&) { return M::to_mont(a); }
  static __device__ __forceinline__ E from_mont(E a, const C&) { return M::from_mont(a); }
  static __device__ __forceinline__ E load(const uint32_t* src, size_t i) { return __ldg(src + i); }
  static __device__ __forceinline__ void store(uint32_t* dst, size_t i, E a) { dst[i] = a; }
};

// Offsets into an instance's constant table, in elements.
template <int T, int HALF, int PARTIAL>
struct Layout {
  static constexpr int kRcFullTop = T;                      // (HALF - 1) T
  static constexpr int kRcPreMatrix = HALF * T;             // T
  static constexpr int kRcPartial = (HALF + 1) * T;         // PARTIAL
  static constexpr int kRcFullBot = (HALF + 1) * T + PARTIAL;  // (HALF - 1) T
  static constexpr int kMds = 2 * HALF * T + PARTIAL;       // T^2
  static constexpr int kPre = kMds + T * T;                 // T^2
  static constexpr int kSparse = kPre + T * T;              // PARTIAL (2T - 1)
  static constexpr int kSize = kSparse + PARTIAL * (2 * T - 1);
};

// The loops below are unrolled where F::kRegisters (state in registers,
// constant offsets fixed at compile time), else rolled up:
// `#pragma unroll (F::kRegisters ? N : 1)`.

// s <- s M for the T x T matrix at table offset `off`.
template <class F, int T, class K>
__device__ __forceinline__ void matmul(typename F::E (&s)[T], const K& k, int off,
                                       const typename F::C& c) {
  using E = typename F::E;
  E out[T];
#pragma unroll (F::kRegisters ? T : 1)
  for (int col = 0; col < T; ++col) {
    E acc = F::mul(s[0], k.get(off + col), c);
#pragma unroll (F::kRegisters ? T : 1)
    for (int r = 1; r < T; ++r) acc = F::add(acc, F::mul(s[r], k.get(off + r * T + col), c), c);
    out[col] = acc;
  }
#pragma unroll (F::kRegisters ? T : 1)
  for (int j = 0; j < T; ++j) s[j] = out[j];
}

// A full round: x^5 and += rc (at `rc`) on every lane, then x the matrix at
// `mat`.
template <class F, int T, class K>
__device__ __forceinline__ void full_round(typename F::E (&s)[T], const K& k, int rc, int mat,
                                           const typename F::C& c) {
#pragma unroll (F::kRegisters ? T : 1)
  for (int j = 0; j < T; ++j) s[j] = F::add(icicle_p2::sbox<F, 5>(s[j], c), k.get(rc + j), c);
  matmul<F, T>(s, k, mat, c);
}

// The digest of one hash: the permutation of the Montgomery-form state s,
// lane 1 of its last product, in Montgomery form.
template <class I, class K>
__device__ __forceinline__ typename I::F::E permute_lane1(typename I::F::E (&s)[I::kT],
                                                          const K& k,
                                                          const typename I::F::C& c) {
  using F = typename I::F;
  using E = typename F::E;
  constexpr int T = I::kT;
  using Lay = Layout<T, I::kHalf, I::kPartial>;
#pragma unroll (F::kRegisters ? T : 1)
  for (int j = 0; j < T; ++j) s[j] = F::add(s[j], k.get(j), c);
#pragma unroll (F::kRegisters ? I::kHalf : 1)
  for (int r = 0; r < I::kHalf - 1; ++r)
    full_round<F, T>(s, k, Lay::kRcFullTop + r * T, Lay::kMds, c);
  full_round<F, T>(s, k, Lay::kRcPreMatrix, Lay::kPre, c);
#pragma unroll (F::kRegisters ? I::kPartial : 1)
  for (int r = 0; r < I::kPartial; ++r) {
    s[0] = F::add(icicle_p2::sbox<F, 5>(s[0], c), k.get(Lay::kRcPartial + r), c);
    const int sp = Lay::kSparse + r * (2 * T - 1);
    E out0 = F::mul(s[0], k.get(sp), c);
#pragma unroll (F::kRegisters ? T : 1)
    for (int j = 1; j < T; ++j) out0 = F::add(out0, F::mul(s[j], k.get(sp + j), c), c);
#pragma unroll (F::kRegisters ? T : 1)
    for (int j = 1; j < T; ++j) s[j] = F::add(F::mul(s[0], k.get(sp + T + j - 1), c), s[j], c);
    s[0] = out0;
  }
#pragma unroll (F::kRegisters ? I::kHalf : 1)
  for (int r = 0; r < I::kHalf - 1; ++r)
    full_round<F, T>(s, k, Lay::kRcFullBot + r * T, Lay::kMds, c);
#pragma unroll (F::kRegisters ? T : 1)
  for (int j = 0; j < T; ++j) s[j] = icicle_p2::sbox<F, 5>(s[j], c);
  E d = F::mul(s[0], k.get(Lay::kMds + 1), c);
#pragma unroll (F::kRegisters ? T : 1)
  for (int r = 1; r < T; ++r) d = F::add(d, F::mul(s[r], k.get(Lay::kMds + r * T + 1), c), c);
  return d;
}

// Hashes one row per thread: n = T - has_tag inputs; tag: lane 0's domain
// tag in Montgomery form where has_tag.
template <class I>
__global__ void __launch_bounds__(kThreads)
poseidon_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, long long batch,
                const typename I::Args a) {
  using F = typename I::F;
  using E = typename F::E;
  constexpr int T = I::kT;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= batch) return;
  const int lead = a.has_tag ? 1 : 0;
  const uint32_t* in = x + static_cast<size_t>(row) * (T - lead) * F::kWords;
  const typename F::C& c = a.c;
  const typename I::K k = I::constants(a);
  E s[T];
  s[0] = lead ? a.tag : F::to_mont(F::load(in, 0), c);
#pragma unroll (F::kRegisters ? T : 1)
  for (int j = 1; j < T; ++j) s[j] = F::to_mont(F::load(in, j - lead), c);
  F::store(out, row, F::from_mont(permute_lane1<I>(s, k, c), c));
}

template <class I>
int launch(const void* x, void* out, long long batch, const typename I::Args& a,
           cudaStream_t stream) {
  const long long blocks = (batch + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  poseidon_kernel<I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), batch, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace icicle_pos
