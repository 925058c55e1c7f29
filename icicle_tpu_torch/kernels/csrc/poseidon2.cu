// Batched Poseidon2 hash on NVIDIA Hopper (sm_90a), one thread per hash.
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
// half_full full rounds. The constants are Montgomery-form device arrays
// that Poseidon2 builds once per (field, t, device): rc (every round's,
// flat), mds (t x t, row-major: out_i = sum_j mds[i t + j] s_j), diag - 1
// (t) and the tag. Every thread reads the same constant at the same step,
// so those loads are broadcasts.
//
// Bound: integer multiplies. babybear at t = 2 (12 full rounds, 24 partial,
// alpha 7) is 4 + 12 (2 * 4 + 4) + 24 (4 + 2) = 292 Montgomery multiplies a
// permutation and 3 more into and out of Montgomery form, 3 integer
// multiplies each: 885 for 12 bytes of input and output, where the card
// does 16.7 T/s / 3.35 TB/s = 5 a byte.
//
// Arithmetic. Single-word fields (p < 2^31: babybear, koalabear, m31):
// Montgomery with R = 2^32, a b R^-1 as math/mont32.py's mul_mont: a 64-bit
// a b (mul.wide), m = lo(a b) (-p^-1 mod 2^32), a b + m p < 2^62 + 2^63
// whose high word is below 2p, one conditional subtract. 8-limb fields
// (bn254_scalar, grumpkin_scalar, bls12_377_scalar, bls12_381_scalar,
// stark252): ec_field.cuh's CIOS mont_mul<8> and add_mod<8>, with R =
// 2^256; mont_mul's one final subtraction needs its result t < 2p < 2^256,
// which holds since each of these moduli is below 2^255 (the wrapper checks
// it). Every result is canonical, so the digest is bit-equal to the plain
// version and to the JAX package whatever the order of the sums.
//
// Design: one thread per hash; templates on t and the limb count, the round
// counts and alpha at run time (the same for every thread: no divergence).
// Single-word fields keep the t-word state in registers: every loop over
// the lanes is unrolled, and the S-box is the plain version's fixed chain.
// 8-limb fields run the same loops rolled up (`kRegisters` false), so the
// t x 8-word state lives in thread-local memory (cached in L1) and the
// S-box is square-and-multiply over alpha's bits (the same multiply count):
// unrolled, an 8-limb multiply is about 250 instructions and the t = 8
// instance alone took minutes of ptxas and spilled at 255 registers. The
// rounds are one loop with one M_ext site, and the permutation has one call
// site (a single permutation is a sponge of one block that loads every
// lane). Rows are read with the row's stride: at t = 2 a thread reads 8
// contiguous bytes. Staging wider rows through shared memory, and hashing
// several Merkle layers a block, are later work (ROADMAP.md queue B).

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

namespace {

constexpr int kThreads = 128;

// The host passes the field as {p[L], one[L], inv32, 0, r2[L]}: one = R mod
// p (the sponge's padding 1 in Montgomery form), r2 = R^2 mod p (into
// Montgomery form); the 0 is CurveConsts' b3, unused here.

// A single-word field, p < 2^31.
struct Word {
  static constexpr bool kRegisters = true;
  using E = uint32_t;
  struct C {
    uint32_t p, one, inv32, r2;
  };
  static C consts(const unsigned int* h) { return C{h[0], h[1], h[2], h[4]}; }
  static __device__ __forceinline__ E add(E a, E b, const C& c) {
    const uint32_t s = a + b;  // < 2p < 2^32
    return s >= c.p ? s - c.p : s;
  }
  static __device__ __forceinline__ E mul(E a, E b, const C& c) {
    const uint64_t ab = static_cast<uint64_t>(a) * b;
    const uint32_t m = static_cast<uint32_t>(ab) * c.inv32;
    const uint32_t h = static_cast<uint32_t>((ab + static_cast<uint64_t>(m) * c.p) >> 32);
    return h >= c.p ? h - c.p : h;
  }
  static __device__ __forceinline__ E load(const uint32_t* src, size_t i) {
    return __ldg(src + i);
  }
  static __device__ __forceinline__ void store(uint32_t* dst, size_t i, E a) { dst[i] = a; }
  static __device__ __forceinline__ E zero() { return 0; }
  static __device__ __forceinline__ E one_mont(const C& c) { return c.one; }
  static __device__ __forceinline__ E r2(const C& c) { return c.r2; }
  static __device__ __forceinline__ E one() { return 1; }
};

// An 8-limb field below 2^255, over ec_field.cuh.
struct Limbs8 {
  static constexpr bool kRegisters = false;
  static constexpr int L = 8;
  using E = icicle_ec::Fp<L>;
  struct C {
    icicle_ec::CurveConsts<L> f;  // p, one, inv32; b3 unused
    E r2;
  };
  static C consts(const unsigned int* h) {
    C c;
    c.f = icicle_ec::consts_from<L>(h);
    for (int j = 0; j < L; ++j) c.r2.v[j] = h[2 * L + 2 + j];
    return c;
  }
  static __device__ __forceinline__ E add(const E& a, const E& b, const C& c) {
    return icicle_ec::add_mod<L>(a, b, c.f);
  }
  static __device__ __forceinline__ E mul(const E& a, const E& b, const C& c) {
    return icicle_ec::mont_mul<L>(a, b, c.f);
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
  static __device__ __forceinline__ E r2(const C& c) { return c.r2; }
  static __device__ __forceinline__ E one() {
    E a = zero();
    a.v[0] = 1;
    return a;
  }
};

// x^alpha, alpha in {3, 5, 7, 9, 11}: the plain version's chain, or (rolled
// up) square-and-multiply from alpha's top bit; 2, 3, 4, 4, 5 multiplies
// either way.
template <class F>
__device__ __forceinline__ typename F::E sbox(const typename F::E& x, int alpha,
                                              const typename F::C& c) {
  if constexpr (F::kRegisters) {
    const typename F::E x2 = F::mul(x, x, c);
    if (alpha == 3) return F::mul(x2, x, c);
    const typename F::E x4 = F::mul(x2, x2, c);
    if (alpha == 5) return F::mul(x4, x, c);
    if (alpha == 7) return F::mul(F::mul(x4, x2, c), x, c);
    if (alpha == 9) return F::mul(F::mul(x4, x4, c), x, c);
    return F::mul(F::mul(F::mul(x4, x4, c), x2, c), x, c);
  } else {
    typename F::E acc = x;
#pragma unroll 1
    for (int bit = 30 - __clz(alpha); bit >= 0; --bit) {
      acc = F::mul(acc, acc, c);
      if ((alpha >> bit) & 1) acc = F::mul(acc, x, c);
    }
    return acc;
  }
}

// The loops over the lanes below are unrolled (state in registers) where
// F::kRegisters, else rolled up: `#pragma unroll (F::kRegisters ? T : 1)`
// (T also for loops of T - 1 trips: at least the trip count, so a full
// unroll, where a count of 1 would keep a one-trip loop rolled).

// s <- M_ext s.
template <class F, int T>
__device__ __forceinline__ void mat_ext(typename F::E (&s)[T], const uint32_t* __restrict__ mds,
                                        const typename F::C& c) {
  typename F::E o[T];
#pragma unroll (F::kRegisters ? T : 1)
  for (int i = 0; i < T; ++i) {
    typename F::E acc = F::mul(F::load(mds, i * T), s[0], c);
#pragma unroll (F::kRegisters ? T : 1)
    for (int j = 1; j < T; ++j) acc = F::add(acc, F::mul(F::load(mds, i * T + j), s[j], c), c);
    o[i] = acc;
  }
#pragma unroll (F::kRegisters ? T : 1)
  for (int i = 0; i < T; ++i) s[i] = o[i];
}

template <class F, int T>
__device__ __forceinline__ void permute(typename F::E (&s)[T], const uint32_t* __restrict__ rc,
                                        const uint32_t* __restrict__ mds,
                                        const uint32_t* __restrict__ diag_m1, int half_full,
                                        int partial, int alpha, const typename F::C& c) {
  mat_ext<F, T>(s, mds, c);
  const int rounds = 2 * half_full + partial;
  size_t off = 0;  // the round's first constant in rc
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    if (r < half_full || r >= half_full + partial) {
#pragma unroll (F::kRegisters ? T : 1)
      for (int j = 0; j < T; ++j) s[j] = sbox<F>(F::add(s[j], F::load(rc, off + j), c), alpha, c);
      mat_ext<F, T>(s, mds, c);
      off += T;
    } else {
      s[0] = sbox<F>(F::add(s[0], F::load(rc, off), c), alpha, c);
      typename F::E tot = s[0];
#pragma unroll (F::kRegisters ? T : 1)
      for (int j = 1; j < T; ++j) tot = F::add(tot, s[j], c);
#pragma unroll (F::kRegisters ? T : 1)
      for (int j = 0; j < T; ++j) s[j] = F::add(tot, F::mul(F::load(diag_m1, j), s[j], c), c);
      off += 1;
    }
  }
}

template <class F, int T>
__global__ void __launch_bounds__(kThreads)
poseidon2_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ rc, const uint32_t* __restrict__ mds,
                 const uint32_t* __restrict__ diag_m1, const uint32_t* __restrict__ tag,
                 long long batch, int n, int half_full, int partial, int alpha,
                 const typename F::C c) {
  using E = typename F::E;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= batch) return;
  const uint32_t* in = x + static_cast<size_t>(row) * n * (sizeof(E) / 4);
  const E r2 = F::r2(c);
  const int lead = tag != nullptr ? 1 : 0;  // 1: lane 0 holds the tag, not an input
  const bool single = n == T - lead;
  // sponge: `rem` inputs after lane 0's, in blocks of T - 1 (at least one)
  const int rem = n - 1 + lead;
  const int blocks = single ? 1 : max(1, (rem + T - 2) / (T - 1));
  E s[T];
  s[0] = lead ? F::load(tag, 0) : F::mul(F::load(in, 0), r2, c);
#pragma unroll (F::kRegisters ? T : 1)
  for (int j = 1; j < T; ++j) s[j] = F::zero();
#pragma unroll 1
  for (int b = 0; b < blocks; ++b) {
#pragma unroll (F::kRegisters ? T : 1)
    for (int j = 1; j < T; ++j) {
      if (single) {
        s[j] = F::mul(F::load(in, j - lead), r2, c);
      } else {
        const int k = b * (T - 1) + j - 1;  // the block's word j - 1, past lane 0's input
        const E v = k < rem ? F::mul(F::load(in, k + 1 - lead), r2, c)
                            : (k == rem ? F::one_mont(c) : F::zero());
        s[j] = F::add(s[j], v, c);
      }
    }
    permute<F, T>(s, rc, mds, diag_m1, half_full, partial, alpha, c);
  }
  F::store(out, row, F::mul(s[1], F::one(), c));
}

template <class F, int T>
int launch(const void* x, void* out, const void* rc, const void* mds, const void* diag_m1,
           const void* tag, long long batch, int n, int half_full, int partial, int alpha,
           const unsigned int* consts, cudaStream_t stream) {
  const long long blocks = (batch + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  poseidon2_kernel<F, T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(rc), static_cast<const uint32_t*>(mds),
      static_cast<const uint32_t*>(diag_m1), static_cast<const uint32_t*>(tag), batch, n,
      half_full, partial, alpha, F::consts(consts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Hashes `batch` rows of n elements on `stream` without synchronising.
// x, out, rc, mds, diag_m1: device pointers; tag: a device pointer to the
// Montgomery-form domain tag, or null. t: the width; L: limbs an element (1
// or 8). consts: host array {p[L], one[L], inv32, 0, r2[L]}. Built for L = 1
// at t in {2, 3, 4, 8, 12, 16, 20, 24} and L = 8 at t in {2, 3, 4, 8}.
// Returns the launch's cudaError_t (0 on success).
int icicle_poseidon2_hash(const void* x, void* out, const void* rc, const void* mds,
                          const void* diag_m1, const void* tag, long long batch, int n, int t,
                          int L, int half_full, int partial, int alpha,
                          const unsigned int* consts, void* stream) {
  if (batch < 1 || n < 1 || half_full < 0 || partial < 0 ||
      (alpha != 3 && alpha != 5 && alpha != 7 && alpha != 9 && alpha != 11))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ICICLE_P2_CASE(F, T)                                                            \
  case T:                                                                              \
    return launch<F, T>(x, out, rc, mds, diag_m1, tag, batch, n, half_full, partial, alpha, \
                        consts, s);
  if (L == 1) {
    switch (t) {
      ICICLE_P2_CASE(Word, 2)
      ICICLE_P2_CASE(Word, 3)
      ICICLE_P2_CASE(Word, 4)
      ICICLE_P2_CASE(Word, 8)
      ICICLE_P2_CASE(Word, 12)
      ICICLE_P2_CASE(Word, 16)
      ICICLE_P2_CASE(Word, 20)
      ICICLE_P2_CASE(Word, 24)
    }
  } else if (L == 8) {
    switch (t) {
      ICICLE_P2_CASE(Limbs8, 2)
      ICICLE_P2_CASE(Limbs8, 3)
      ICICLE_P2_CASE(Limbs8, 4)
      ICICLE_P2_CASE(Limbs8, 8)
    }
  }
#undef ICICLE_P2_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
