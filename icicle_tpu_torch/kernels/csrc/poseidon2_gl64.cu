// The goldilocks Poseidon2 instances (t = 2, 3, 4, 8, 12) on NVIDIA Hopper
// (sm_90a); the kernel and its design are in poseidon2.cuh, the arithmetic
// in gl64.cuh. Bound to Python with ctypes
// (icicle_tpu_torch/kernels/poseidon2_kernel.py: poseidon2).

#include "poseidon2.cuh"

namespace {

using namespace icicle_p2;

// (field, t, half_full, partial, alpha) of goldilocks' constants
// (ops/hash/data/poseidon2_goldilocks.npz, its t<t>_meta);
// tests/test_torch_poseidon2_layers.py holds this table against the file.
#define POSEIDON2_GL64(X)      \
  X(goldilocks, 2, 4, 27, 7)   \
  X(goldilocks, 3, 4, 23, 7)   \
  X(goldilocks, 4, 4, 21, 7)   \
  X(goldilocks, 8, 4, 22, 7)   \
  X(goldilocks, 12, 4, 22, 7)

// A goldilocks instance: constants in global memory (Poseidon2's device
// arrays), one uniform 8-byte load each, the state in registers.
template <int T, int HALF, int PARTIAL, int ALPHA>
struct Gl64Instance {
  using F = Gl64;
  static constexpr int kT = T, kHalf = HALF, kPartial = PARTIAL, kAlpha = ALPHA;
  struct Args {
    F::C c;
    F::E tag;
    int has_tag;
    const uint32_t* rc;
    const uint32_t* diag_m1;
  };
  struct K {
    const uint32_t* rcp;
    const uint32_t* diagp;
    __device__ __forceinline__ F::E rc(int i) const { return F::load(rcp, i); }
    __device__ __forceinline__ F::E diag_m1(int i) const { return F::load(diagp, i); }
  };
  static __device__ __forceinline__ K constants(const Args& a) { return K{a.rc, a.diag_m1}; }
};

}  // namespace

extern "C" {

// Hashes `batch` rows of n goldilocks elements on `stream` without
// synchronising. x, out, rc, diag_m1: device pointers (rc and diag_m1: the
// round constants and d - 1, two words an element). t: the width. tag: a
// host pointer to the domain tag's two words, or null. Built for the
// POSEIDON2_GL64 counts. Returns the launch's cudaError_t (0 on success).
int icicle_poseidon2_gl64_hash(const void* x, void* out, const void* rc, const void* diag_m1,
                               const unsigned int* tag, long long batch, int n, int t,
                               int half_full, int partial, int alpha, void* stream) {
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ICICLE_P2_GL64_CASE(FIELD, T, HALF, PARTIAL, ALPHA)                              \
  if (t == (T)) {                                                                        \
    if (half_full != (HALF) || partial != (PARTIAL) || alpha != (ALPHA))                 \
      return static_cast<int>(cudaErrorInvalidValue);                                    \
    using I = Gl64Instance<T, HALF, PARTIAL, ALPHA>;                                     \
    I::Args a{};                                                                         \
    a.has_tag = tag != nullptr ? 1 : 0;                                                  \
    a.tag = tag != nullptr ? (static_cast<uint64_t>(tag[1]) << 32) | tag[0] : 0;         \
    a.rc = static_cast<const uint32_t*>(rc);                                             \
    a.diag_m1 = static_cast<const uint32_t*>(diag_m1);                                   \
    return n == (T) - a.has_tag ? launch<I, false>(x, out, batch, n, a, s)               \
                                : launch<I, true>(x, out, batch, n, a, s);               \
  }
  POSEIDON2_GL64(ICICLE_P2_GL64_CASE)
#undef ICICLE_P2_GL64_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
