// The 8-limb Poseidon instances (bn254_scalar, grumpkin_scalar,
// bls12_377_scalar, bls12_381_scalar, stark252 at t = 3, 5, 9, 12) on
// NVIDIA Hopper (sm_90a), one thread a hash. Bound to Python with ctypes
// (icicle_tpu_torch/kernels/poseidon_kernel.py: poseidon). The function,
// the constant table's layout (Layout) and the bound are poseidon.cuh's;
// this file computes it over ec_wide.cuh's arithmetic.
//
// Design, for a kernel bound by its integer multiplies:
// - Arithmetic: ec_wide.cuh's carry-chain Montgomery multiply (two
//   accumulator chains, a mad.lo.cc / madc.hi.cc pair one IMAD.WIDE). A
//   field whose modulus leaves two bits spare (4p < 2^256: bn254_scalar,
//   grumpkin_scalar, bls12_377_scalar, stark252) keeps its values lazy in
//   [0, 2p) between the loads and the digest (the Wide8<true> instances).
//   bls12_381_scalar (top word 0x73eda753, 4p > 2^256) cannot: there every
//   product and sum ends in `canonical` (Wide8<false>). With inputs below p
//   < 2^255 the multiply's sums stay below 2^32 (a + p) < 2^288 and its
//   result below 2p < 2^256, so the same multiply serves both. The C entry
//   picks the instance by the modulus's top two bits.
// - State in registers: the loops over the lanes and the matrix rows are
//   unrolled over T, so every lane is a register; the round loop is rolled
//   (one body for the full rounds, one for the partial ones, the round's
//   table offsets computed from its index), and so is a matrix product's
//   loop over its columns, whose result goes to the right lane by a
//   compare against the column (moves, no indexing): unrolled, a t = 12
//   round is 144 inline multiplies, and an 8-limb Poseidon2 unrolled that
//   way once took minutes of ptxas. The last round computes lane 1's column
//   only (the digest).
// - Constants from the table in device memory, two 16-byte uniform loads
//   an element (the same address in every lane of a warp); a copy of the
//   table in shared memory was measured slower at P1's shape (PERF.md).
// Every product is reduced, so the multiplies are poseidon.cuh's count
// (poseidon_kernel.needed_monts).

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_wide.cuh"
#include "poseidon.cuh"

namespace {

using namespace icicle_pos;
namespace wide = icicle_ec::wide;

// An 8-limb field below 2^255 over ec_wide.cuh; kLazy: values in [0, 2p)
// (needs 4p < 2^256), else canonical after every step.
template <bool kLazy>
struct Wide8 {
  static constexpr int L = 8;
  using E = icicle_ec::Fp<L>;
  struct C {
    wide::BaseConsts<L> f;
    E r2;
  };
  // The host passes {p[L], one[L], inv32, 0, r2[L]}.
  static C consts(const unsigned int* h) {
    C c;
    c.f = wide::base_consts<L>(icicle_ec::consts_from<L>(h));
    for (int j = 0; j < L; ++j) c.r2.v[j] = h[2 * L + 2 + j];
    return c;
  }
  static __device__ __forceinline__ E mul(const E& a, const E& b, const C& c) {
    const E r = wide::mul<L>(a, b, c.f);
    return kLazy ? r : wide::canonical<L>(r, c.f);
  }
  static __device__ __forceinline__ E add(const E& a, const E& b, const C& c) {
    const E r = wide::add<L>(a, b, c.f);
    return kLazy ? r : wide::canonical<L>(r, c.f);
  }
  static __device__ __forceinline__ E to_mont(const E& a, const C& c) { return mul(a, c.r2, c); }
  static __device__ __forceinline__ E from_mont(const E& a, const C& c) {
    E one;
#pragma unroll
    for (int j = 0; j < L; ++j) one.v[j] = j == 0 ? 1u : 0u;
    return wide::canonical<L>(wide::mul<L>(a, one, c.f), c.f);
  }
  static __device__ __forceinline__ E load(const uint32_t* src, size_t i) {
    E a;
#pragma unroll
    for (int j = 0; j < L; ++j) a.v[j] = __ldg(src + i * L + j);
    return a;
  }
  // element i of the constant table, two 16-byte words an element
  static __device__ __forceinline__ E get(const uint4* table, int i) {
    const uint4 lo = __ldg(table + 2 * i), hi = __ldg(table + 2 * i + 1);
    return {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
  }
  static __device__ __forceinline__ E sbox(const E& x, const C& c) {  // x^5
    const E x2 = mul(x, x, c);
    return mul(mul(x2, x2, c), x, c);
  }
};

// (t, half, partial) of the 8-limb fields' constants, shared by fields with
// the same counts: bls12_381_scalar alone has 55 partial rounds at t = 3;
// tests/test_torch_poseidon.py holds this table against the .npz files.
// Each is built lazy and canonical.
#define POSEIDON_LIMBS(X) \
  X(3, 4, 55)             \
  X(3, 4, 56)             \
  X(5, 4, 56)             \
  X(9, 4, 57)             \
  X(12, 4, 57)

template <int T, int HALF, int PARTIAL, bool kLazy>
struct Limbs {
  using F = Wide8<kLazy>;
  static constexpr int kT = T, kHalf = HALF, kPartial = PARTIAL;
  struct Args {
    typename F::C c;
    typename F::E tag;
    int has_tag;
    const uint32_t* table;
  };
};

// Hashes one row per thread: n = T - has_tag inputs; tag: lane 0's domain
// tag in Montgomery form where has_tag. The rounds after rc_pre: HALF full
// (the last of them with pre_matrix), PARTIAL partial, HALF full (the last
// without round constants, its product lane 1's column alone).
template <class I>
__global__ void __launch_bounds__(kThreads)
wide_poseidon_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     long long batch, const typename I::Args a) {
  using F = typename I::F;
  using E = typename F::E;
  constexpr int T = I::kT, HALF = I::kHalf, PARTIAL = I::kPartial;
  constexpr int kRounds = 2 * HALF + PARTIAL;
  using Lay = Layout<T, HALF, PARTIAL>;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const uint4* tab = reinterpret_cast<const uint4*>(a.table);
  if (row >= batch) return;
  const int lead = a.has_tag ? 1 : 0;
  const uint32_t* in = x + static_cast<size_t>(row) * (T - lead) * F::L;
  const typename F::C& c = a.c;
  E s[T];
  s[0] = lead ? a.tag : F::to_mont(F::load(in, 0), c);
#pragma unroll
  for (int j = 1; j < T; ++j) s[j] = F::to_mont(F::load(in, j - lead), c);
#pragma unroll
  for (int j = 0; j < T; ++j) s[j] = F::add(s[j], F::get(tab, j), c);
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    if (r >= HALF && r < HALF + PARTIAL) {
      // x^5 and += rc on lane 0, then the sparse matrix:
      // out_0 = <s, col0>, out_j = s_0 row0[j - 1] + s_j
      const int sp = Lay::kSparse + (r - HALF) * (2 * T - 1);
      s[0] = F::add(F::sbox(s[0], c), F::get(tab, Lay::kRcPartial + r - HALF), c);
      E out0 = F::mul(s[0], F::get(tab, sp), c);
#pragma unroll
      for (int j = 1; j < T; ++j)
        out0 = F::add(out0, F::mul(s[j], F::get(tab, sp + j), c), c);
#pragma unroll
      for (int j = 1; j < T; ++j)
        s[j] = F::add(F::mul(s[0], F::get(tab, sp + T + j - 1), c), s[j], c);
      s[0] = out0;
      continue;
    }
    const bool last = r == kRounds - 1;
    const int rc =
        r < HALF ? Lay::kRcFullTop + r * T : Lay::kRcFullBot + (r - HALF - PARTIAL) * T;
    const int mat = r == HALF - 1 ? Lay::kPre : Lay::kMds;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      s[j] = F::sbox(s[j], c);
      if (!last) s[j] = F::add(s[j], F::get(tab, rc + j), c);
    }
    // s <- s M: out_col = sum_r s_r M[r, col], a column at a time
    E o[T];
#pragma unroll
    for (int j = 0; j < T; ++j) o[j] = s[j];
#pragma unroll 1
    for (int col = last ? 1 : 0; col < (last ? 2 : T); ++col) {
      E acc = F::mul(s[0], F::get(tab, mat + col), c);
#pragma unroll
      for (int k = 1; k < T; ++k)
        acc = F::add(acc, F::mul(s[k], F::get(tab, mat + k * T + col), c), c);
#pragma unroll
      for (int j = 0; j < T; ++j)
        if (j == col) o[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < T; ++j) s[j] = o[j];
  }
  const E d = F::from_mont(s[1], c);
#pragma unroll
  for (int j = 0; j < F::L; ++j) out[static_cast<size_t>(row) * F::L + j] = d.v[j];
}

template <class I>
int launch_wide(const void* x, void* out, const void* table, const unsigned int* tag,
                long long batch, const unsigned int* consts, cudaStream_t stream) {
  typename I::Args a{};
  a.c = I::F::consts(consts);
  a.has_tag = tag != nullptr ? 1 : 0;
  for (int j = 0; j < 8; ++j) a.tag.v[j] = tag != nullptr ? tag[j] : 0u;
  a.table = static_cast<const uint32_t*>(table);
  const long long blocks = (batch + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  wide_poseidon_kernel<I><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), batch, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Hashes `batch` rows of t - has_tag 8-limb elements on `stream` without
// synchronising. x, out, table: device pointers (table: the instance's
// constants in Montgomery form, poseidon.cuh's Layout, 16-byte aligned).
// consts: host array {p[8], one[8], inv32, 0, r2[8]}, p < 2^255; the lazy
// instance where 4p < 2^256. tag: a host pointer to the Montgomery-form
// domain tag's 8 words, or null. Built for the POSEIDON_LIMBS counts.
// Returns the launch's cudaError_t (0 on success).
int icicle_poseidon_limbs_hash(const void* x, void* out, const void* table,
                               const unsigned int* tag, long long batch, int t, int half,
                               int partial, const unsigned int* consts, void* stream) {
  if (batch < 1 || (reinterpret_cast<uintptr_t>(table) & 15u) != 0 || (consts[7] >> 31) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool lazy = (consts[7] >> 30) == 0;
#define ICICLE_POS_LIMBS_CASE(T, HALF, PARTIAL)                                          \
  if (t == (T) && half == (HALF) && partial == (PARTIAL))                                \
    return lazy ? launch_wide<Limbs<T, HALF, PARTIAL, true>>(x, out, table, tag, batch,  \
                                                             consts, s)                  \
                : launch_wide<Limbs<T, HALF, PARTIAL, false>>(x, out, table, tag, batch, \
                                                              consts, s);
  POSEIDON_LIMBS(ICICLE_POS_LIMBS_CASE)
#undef ICICLE_POS_LIMBS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
