// Batched Poseidon2 hash on NVIDIA Hopper (sm_90a), one thread per hash:
// the code shared by the single-word instances (poseidon2.cu), the 8-limb
// ones (poseidon2_limbs.cu) and the goldilocks ones (poseidon2_gl64.cu),
// three libraries that build in parallel.
// Bound to Python with ctypes (icicle_tpu_torch/kernels/poseidon2_kernel.py:
// poseidon2).
//
// No TPU kernel is replaced: the JAX package computes the permutation as XLA
// (icicle_tpu/ops/hash/poseidon2.py:211 permute_mont, jitted with the
// sponge in _hash_fields_impl), which fuses the rounds into one program.
// This kernel is that program for a batch: each thread reads its row's n
// inputs, takes them into Montgomery form, runs one permutation (n == t, or
// n == t - 1 with a domain tag in lane 0) or the sponge (any other n: lane 0
// holds the tag or the first input, each further block of t - 1 inputs is
// added into lanes 1..t-1 and permuted, the last block padded [1, 0, ...]),
// and writes lane 1 out of Montgomery form.
//   in  (batch, n) uint32 canonical elements, or (batch, n, 8) limbs;
//   out (batch,) or (batch, 8), canonical.
// The permutation is the reference's: M_ext once, half_full full rounds (+RC
// and x^alpha on every lane, then M_ext), partial rounds (+RC and x^alpha on
// lane 0, then M_int = ones + diag(d - 1): out_i = sum_j s_j + (d_i - 1) s_i),
// half_full full rounds.
//
// Linear layers by adds. M_ext has small integer entries at every width the
// repo instantiates, and the kernel applies it as an add chain, not as t^2
// Montgomery multiplies: t = 2, 3: 2 on the diagonal and 1 elsewhere
// (out_i = s_i + sum_j s_j); t = 4: the reference's M4 = [[5,7,1,3],
// [4,6,1,1],[1,3,5,7],[1,1,4,6]] by its chain of 8 adds and 6 doublings;
// t = 8..24: circ(2 M4, M4, ..., M4), i.e. M4 on each chunk of 4 lanes, then
// each lane plus the sum of its column over the chunks. M_int at t = 2 and 3
// has d - 1 = (1, 2) and (1, 1, 2): adds and a doubling; at t >= 4 its
// diagonal is a general element and stays t Montgomery multiplies. A
// multiply by a small integer k of a Montgomery-form value is the same value
// as the Montgomery multiply by k's Montgomery form, so every lane keeps the
// plain version's canonical value. The wrapper checks that the field's
// constants are exactly this structure (poseidon2_kernel.py
// check_linear_layers) before it launches.
//
// Rounds fixed at compile time. Every instance (field, t) carries its
// half_full, partial and alpha as constants (the tables POSEIDON2_WORDS in
// poseidon2.cu, POSEIDON2_LIMBS in poseidon2_limbs.cu and POSEIDON2_GL64
// in poseidon2_gl64.cu; the C entries
// refuse a call whose counts differ). Single-word instances
// keep the state in registers and, for one permutation, unroll every round:
// each round constant is then a compile-time offset into the instance's
// __constant__ array (an operand of the add, no load and no address
// arithmetic), written once per (field, t, device) by
// icicle_poseidon2_upload. Their sponge kernel runs the same rounds rolled
// up. 8-limb instances roll their lane and round loops up (state in thread-
// local memory): unrolled, the t = 8 instance took minutes of ptxas and
// spilled at 255 registers; they read the constants from the global arrays
// that Poseidon2 keeps on the device, one uniform load a limb, small
// beside a 264-multiply mont_mul<8>. Their 8-limb constants fill about 61 KB
// across the five fields, near the 64 KB constant bank.
//
// Arithmetic. Single-word fields (p < 2^31: babybear, koalabear, m31) use
// Montgomery with R = 2^32 and p, p^-1 mod 2^32, R mod p and R^2 mod p as
// compile-time constants; every value stays canonical in [0, p).
//   add: s = a + b < 2p < 2^32; min(s, s - p) as unsigned (s - p wraps above
//     s when s < p): an add and one add-and-minimum (VIADDMNMX), no
//     compare and select.
//   mul: a b R^-1 mod p for a < 2^32, b < p (a b < p 2^32):
//     ab = a b (one wide multiply), m = lo(ab) p^-1 mod 2^32, so that
//     m p = ab mod 2^32 and (ab - m p) / 2^32 = hi(ab) - hi(m p) exactly,
//     with hi(ab) < p and hi(m p) < p: r in (-p, p); min(r, r + p) as
//     unsigned is r mod p (for r < 0, r + p wraps to the smaller value).
//     Three multiply instructions (two wide) and two ALU instructions (the
//     subtract, and one add-and-minimum), against mul.wide, mul, mul.wide,
//     a 64-bit add and a compare and select before. Taking hi(ab) and
//     hi(m p) from __umulhi and lo(ab) from a 32-bit multiply gives the
//     same values in more instructions: 23.8 against 20.1 ms at the 2^29
//     tree's leaf layer on the H100 (PERF.md).
//   No lazy reduction: p > 2^30 leaves no headroom for a sum of three
//   values or for a product of two values above p, and every multiply here
//   squares a fresh sum or takes a canonical constant.
// Goldilocks (poseidon2_gl64.cu, t = 2, 3, 4, 8, 12, 16, 20, 24):
// gl64.cuh's lazy add and multiply on one uint64 a lane: between the load
// and the store a lane holds any 64-bit word congruent to its value, and
// the digest is made canonical once, at its store (`from_mont`), so it is
// bit-equal to the plain version. A multiply is four 32x32 products and
// the folds of 2^96 = -1 and 2^64 = eps as carry chains, an add a 64-bit
// add and its carries folded back as eps, none with a compare or a final
// subtract (as in ntt_wide.cu's Gl64 instance). The field has no
// Montgomery form, so the conversion in is none and the constants are
// plain values. Its M_ext and, at t = 2 and 3, its M_int have the structure above; at t >= 4
// M_int's diagonal is general, t multiplies a partial round. State in
// registers, every round of one permutation unrolled up to t = 12 (above,
// the rounds rolled: compile time), as the single-word instances; the
// constants come from the global arrays, as the 8-limb ones'.
// 8-limb fields (bn254_scalar, grumpkin_scalar, bls12_377_scalar,
// bls12_381_scalar, stark252): ec_field.cuh's CIOS mont_mul<8> and
// add_mod<8> with R = 2^256; mont_mul's one final subtraction needs its
// result t < 2p < 2^256, which holds since each of these moduli is below
// 2^255 (the wrapper checks it). Every result is canonical, so the digest
// is bit-equal to the plain version and to the JAX package.
//
// Bound: integer multiplies. babybear at t = 2 (12 full rounds, 24 partial,
// alpha 7) needs 12 * 2 * 4 + 24 * 4 = 192 Montgomery multiplies a
// permutation (the S-boxes; the linear layers are adds) and 3 more into and
// out of Montgomery form: 195, 3 integer multiplies each, 585 for 12 bytes
// of input and output, where the card does 16.7 T/s / 3.35 TB/s = 5 a byte
// (poseidon2_kernel.needed_monts).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"
#include "gl64.cuh"

namespace icicle_p2 {

constexpr int kThreads = 128;

// p^-1 mod 2^32 for odd p: Newton's iteration from p (right to 3 bits).
constexpr uint32_t inverse32(uint32_t p) {
  uint32_t x = p;
  for (int i = 0; i < 4; ++i) x *= 2u - p * x;
  return x;
}

// A single-word field, p < 2^31, its constants known at compile time.
template <uint32_t P>
struct Word {
  static constexpr bool kRegisters = true;
  static constexpr int kUnrolledT = 24;  // one permutation unrolled up to this width
  static constexpr int kWords = 1;
  static constexpr uint32_t pinv = inverse32(P);  // p pinv = 1 mod 2^32
  static constexpr uint32_t one = static_cast<uint32_t>((uint64_t{1} << 32) % P);  // R mod p
  static constexpr uint32_t r2 = static_cast<uint32_t>(uint64_t{one} * one % P);   // R^2 mod p
  static_assert(P < (1u << 31) && (P & 1u) && P * pinv == 1u, "an odd p below 2^31");
  using E = uint32_t;
  struct C {};  // nothing at run time
  static __device__ __forceinline__ E add(E a, E b, const C&) {
    const uint32_t s = a + b;  // a, b < p: s < 2p < 2^32
    return min(s, s - P);
  }
  static __device__ __forceinline__ E dbl(E a, const C& c) { return add(a, a, c); }
  static __device__ __forceinline__ E mul(E a, E b, const C&) {
    const uint64_t ab = static_cast<uint64_t>(a) * b;
    const uint32_t m = static_cast<uint32_t>(ab) * pinv;
    const uint32_t r = static_cast<uint32_t>(ab >> 32) -
                       static_cast<uint32_t>((static_cast<uint64_t>(m) * P) >> 32);
    return min(r, r + P);  // r in (-p, p) -> [0, p)
  }
  static __device__ __forceinline__ E to_mont(E a, const C& c) { return mul(a, r2, c); }
  static __device__ __forceinline__ E from_mont(E a, const C& c) { return mul(a, 1u, c); }
  static __device__ __forceinline__ E zero() { return 0; }
  static __device__ __forceinline__ E one_mont(const C&) { return one; }
  static __device__ __forceinline__ E load(const uint32_t* src, size_t i) { return __ldg(src + i); }
  static __device__ __forceinline__ void store(uint32_t* dst, size_t i, E a) { dst[i] = a; }
};

// An 8-limb field below 2^255, over ec_field.cuh; the field's constants at
// run time: {p, one, inv32} and R^2 mod p.
struct Limbs8 {
  static constexpr bool kRegisters = false;
  static constexpr int kUnrolledT = 0;
  static constexpr int L = 8;
  static constexpr int kWords = L;
  using E = icicle_ec::Fp<L>;
  struct C {
    icicle_ec::CurveConsts<L> f;  // p, one, inv32; b3 unused
    E r2;
  };
  // The host passes {p[L], one[L], inv32, 0, r2[L]}.
  static C consts(const unsigned int* h) {
    C c;
    c.f = icicle_ec::consts_from<L>(h);
    for (int j = 0; j < L; ++j) c.r2.v[j] = h[2 * L + 2 + j];
    return c;
  }
  static __device__ __forceinline__ E add(const E& a, const E& b, const C& c) {
    return icicle_ec::add_mod<L>(a, b, c.f);
  }
  static __device__ __forceinline__ E dbl(const E& a, const C& c) { return add(a, a, c); }
  static __device__ __forceinline__ E mul(const E& a, const E& b, const C& c) {
    return icicle_ec::mont_mul<L>(a, b, c.f);
  }
  static __device__ __forceinline__ E to_mont(const E& a, const C& c) { return mul(a, c.r2, c); }
  static __device__ __forceinline__ E from_mont(const E& a, const C& c) {
    E one = zero();
    one.v[0] = 1;
    return mul(a, one, c);
  }
  static __device__ __forceinline__ E zero() {
    E a;
#pragma unroll
    for (int j = 0; j < L; ++j) a.v[j] = 0;
    return a;
  }
  static __device__ __forceinline__ E one_mont(const C& c) {
    E a;
#pragma unroll
    for (int j = 0; j < L; ++j) a.v[j] = c.f.one[j];
    return a;
  }
  static __device__ __forceinline__ E load(const uint32_t* src, size_t i) {
    E a;
#pragma unroll
    for (int j = 0; j < L; ++j) a.v[j] = __ldg(src + i * L + j);
    return a;
  }
  static __device__ __forceinline__ void store(uint32_t* dst, size_t i, const E& a) {
#pragma unroll
    for (int j = 0; j < L; ++j) dst[i * L + j] = a.v[j];
  }
};

// Goldilocks (gl64.cuh's lazy functions): one uint64 a lane, any word
// congruent to the value; no Montgomery form, nothing at run time.
// from_mont makes the digest canonical.
struct Gl64 {
  static constexpr bool kRegisters = true;
  // wider permutations keep their round loops rolled (the lanes unrolled):
  // with every round of t = 16, 20, 24 unrolled the library took 355 s of
  // nvcc on the H100 machine
  static constexpr int kUnrolledT = 12;
  static constexpr int kWords = 2;
  using E = uint64_t;
  struct C {};
  static __device__ __forceinline__ E add(E a, E b, const C&) { return icicle_gl::lazy_add(a, b); }
  static __device__ __forceinline__ E dbl(E a, const C&) { return icicle_gl::lazy_add(a, a); }
  static __device__ __forceinline__ E mul(E a, E b, const C&) { return icicle_gl::lazy_mul(a, b); }
  static __device__ __forceinline__ E to_mont(E a, const C&) { return a; }
  static __device__ __forceinline__ E from_mont(E a, const C&) { return icicle_gl::canonical(a); }
  static __device__ __forceinline__ E zero() { return 0; }
  static __device__ __forceinline__ E one_mont(const C&) { return 1; }
  static __device__ __forceinline__ E load(const uint32_t* src, size_t i) {
    return __ldg(reinterpret_cast<const unsigned long long*>(src) + i);
  }
  static __device__ __forceinline__ void store(uint32_t* dst, size_t i, E a) {
    reinterpret_cast<uint64_t*>(dst)[i] = a;
  }
};

// x^alpha by the plain version's chain: 2, 3, 4, 4, 5 multiplies for alpha
// 3, 5, 7, 9, 11.
template <class F, int A>
__device__ __forceinline__ typename F::E sbox(const typename F::E& x, const typename F::C& c) {
  static_assert(A == 3 || A == 5 || A == 7 || A == 9 || A == 11, "alpha");
  const typename F::E x2 = F::mul(x, x, c);
  if constexpr (A == 3) return F::mul(x2, x, c);
  const typename F::E x4 = F::mul(x2, x2, c);
  if constexpr (A == 5) return F::mul(x4, x, c);
  if constexpr (A == 7) return F::mul(F::mul(x4, x2, c), x, c);
  if constexpr (A == 9) return F::mul(F::mul(x4, x4, c), x, c);
  return F::mul(F::mul(F::mul(x4, x4, c), x2, c), x, c);
}

// The loops over the lanes below are unrolled (state in registers) where
// F::kRegisters, else rolled up: `#pragma unroll (F::kRegisters ? N : 1)`
// (N also for loops of N - 1 trips: at least the trip count, so a full
// unroll, where a count of 1 would keep a one-trip loop rolled).

// (x0, x1, x2, x3) <- M4 (x0, x1, x2, x3), the reference's chain.
template <class F>
__device__ __forceinline__ void m4(typename F::E& x0, typename F::E& x1, typename F::E& x2,
                                   typename F::E& x3, const typename F::C& c) {
  using E = typename F::E;
  const E t0 = F::add(x0, x1, c);                               // x0 + x1
  const E t1 = F::add(x2, x3, c);                               // x2 + x3
  const E t2 = F::add(F::dbl(x1, c), t1, c);                    // 2 x1 + x2 + x3
  const E t3 = F::add(F::dbl(x3, c), t0, c);                    // x0 + x1 + 2 x3
  const E t4 = F::add(F::dbl(F::dbl(t1, c), c), t3, c);         // x0 + x1 + 4 x2 + 6 x3
  const E t5 = F::add(F::dbl(F::dbl(t0, c), c), t2, c);         // 4 x0 + 6 x1 + x2 + x3
  x0 = F::add(t3, t5, c);                                       // 5 x0 + 7 x1 + x2 + 3 x3
  x1 = t5;
  x2 = F::add(t2, t4, c);                                       // x0 + 3 x1 + 5 x2 + 7 x3
  x3 = t4;
}

// s <- M_ext s.
template <class F, int T>
__device__ __forceinline__ void ext_layer(typename F::E (&s)[T], const typename F::C& c) {
  using E = typename F::E;
  if constexpr (T <= 3) {
    E tot = s[0];
#pragma unroll
    for (int j = 1; j < T; ++j) tot = F::add(tot, s[j], c);
#pragma unroll
    for (int j = 0; j < T; ++j) s[j] = F::add(s[j], tot, c);
  } else {
    static_assert(T % 4 == 0, "t = 4, 8, 12, ...");
#pragma unroll (F::kRegisters ? T / 4 : 1)
    for (int q = 0; q < T / 4; ++q) m4<F>(s[4 * q], s[4 * q + 1], s[4 * q + 2], s[4 * q + 3], c);
    if constexpr (T > 4) {
#pragma unroll (F::kRegisters ? 4 : 1)
      for (int k = 0; k < 4; ++k) {
        E col = s[k];
#pragma unroll (F::kRegisters ? T / 4 : 1)
        for (int q = 1; q < T / 4; ++q) col = F::add(col, s[4 * q + k], c);
#pragma unroll (F::kRegisters ? T / 4 : 1)
        for (int q = 0; q < T / 4; ++q) s[4 * q + k] = F::add(s[4 * q + k], col, c);
      }
    }
  }
}

// s <- M_int s: out_i = sum_j s_j + (d_i - 1) s_i; d - 1 = (1, 2) at t = 2,
// (1, 1, 2) at t = 3, else diag_m1(i) in Montgomery form.
template <class F, int T, class K>
__device__ __forceinline__ void int_layer(typename F::E (&s)[T], const K& k,
                                          const typename F::C& c) {
  using E = typename F::E;
  E tot = s[0];
#pragma unroll (F::kRegisters ? T : 1)
  for (int j = 1; j < T; ++j) tot = F::add(tot, s[j], c);
  if constexpr (T <= 3) {
#pragma unroll
    for (int j = 0; j < T - 1; ++j) s[j] = F::add(tot, s[j], c);
    s[T - 1] = F::add(tot, F::dbl(s[T - 1], c), c);
  } else {
#pragma unroll (F::kRegisters ? T : 1)
    for (int j = 0; j < T; ++j) s[j] = F::add(tot, F::mul(k.diag_m1(j), s[j], c), c);
  }
}

template <class I, class K>
__device__ __forceinline__ void full_round(typename I::F::E (&s)[I::kT], const K& k, int off,
                                           const typename I::F::C& c) {
  using F = typename I::F;
#pragma unroll (F::kRegisters ? I::kT : 1)
  for (int j = 0; j < I::kT; ++j) s[j] = sbox<F, I::kAlpha>(F::add(s[j], k.rc(off + j), c), c);
  ext_layer<F, I::kT>(s, c);
}

// One permutation of instance I; kUnroll: every round unrolled (the round
// constants' offsets then fixed at compile time).
template <class I, bool kUnroll, class K>
__device__ __forceinline__ void permute(typename I::F::E (&s)[I::kT], const K& k,
                                        const typename I::F::C& c) {
  using F = typename I::F;
  constexpr int T = I::kT;
  ext_layer<F, T>(s, c);
#pragma unroll (kUnroll ? I::kHalf : 1)
  for (int r = 0; r < I::kHalf; ++r) full_round<I>(s, k, r * T, c);
#pragma unroll (kUnroll ? I::kPartial : 1)
  for (int r = 0; r < I::kPartial; ++r) {
    s[0] = sbox<F, I::kAlpha>(F::add(s[0], k.rc(I::kHalf * T + r), c), c);
    int_layer<F, T>(s, k, c);
  }
#pragma unroll (kUnroll ? I::kHalf : 1)
  for (int r = 0; r < I::kHalf; ++r) full_round<I>(s, k, I::kHalf * T + I::kPartial + r * T, c);
}

// Hashes one row per thread. kSponge false: n == t - lead inputs, one
// permutation; true: the sponge over any n (one block when n == t - lead).
// tag: lane 0's domain tag in Montgomery form where has_tag.
template <class I, bool kSponge>
__global__ void __launch_bounds__(kThreads)
poseidon2_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, long long batch,
                 int n, const typename I::Args a) {
  using F = typename I::F;
  using E = typename F::E;
  constexpr int T = I::kT;
  constexpr bool kUnroll = F::kRegisters && !kSponge && T <= F::kUnrolledT;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= batch) return;
  const uint32_t* in = x + static_cast<size_t>(row) * n * F::kWords;
  const typename F::C& c = a.c;
  const typename I::K k = I::constants(a);
  const int lead = a.has_tag ? 1 : 0;  // 1: lane 0 holds the tag, not an input
  E s[T];
  s[0] = lead ? a.tag : F::to_mont(F::load(in, 0), c);
  if constexpr (!kSponge) {
#pragma unroll
    for (int j = 1; j < T; ++j) s[j] = F::to_mont(F::load(in, j - lead), c);
    permute<I, kUnroll>(s, k, c);
  } else {
#pragma unroll (F::kRegisters ? T : 1)
    for (int j = 1; j < T; ++j) s[j] = F::zero();
    // `rem` inputs after lane 0's, in blocks of T - 1 (at least one)
    const int rem = n - 1 + lead;
    const int blocks = max(1, (rem + T - 2) / (T - 1));
#pragma unroll 1
    for (int b = 0; b < blocks; ++b) {
#pragma unroll (F::kRegisters ? T : 1)
      for (int j = 1; j < T; ++j) {
        const int q = b * (T - 1) + j - 1;  // the block's word j - 1, past lane 0's input
        const E v = q < rem ? F::to_mont(F::load(in, q + 1 - lead), c)
                            : (q == rem ? F::one_mont(c) : F::zero());
        s[j] = F::add(s[j], v, c);
      }
      permute<I, kUnroll>(s, k, c);
    }
  }
  F::store(out, row, F::from_mont(s[1], c));
}

template <class I, bool kSponge>
int launch(const void* x, void* out, long long batch, int n, const typename I::Args& a,
           cudaStream_t stream) {
  const long long blocks = (batch + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  poseidon2_kernel<I, kSponge><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), batch, n, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace icicle_p2
