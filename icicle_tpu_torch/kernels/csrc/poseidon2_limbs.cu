// The 8-limb Poseidon2 instances (bn254_scalar, grumpkin_scalar,
// bls12_377_scalar, bls12_381_scalar, stark252 at t = 2, 3, 4, 8) on NVIDIA
// Hopper (sm_90a); the kernel and its design are in poseidon2.cuh. Bound
// to Python with ctypes (icicle_tpu_torch/kernels/poseidon2_kernel.py:
// poseidon2).

#include "poseidon2.cuh"

namespace {

using namespace icicle_p2;

// (t, half_full, partial, alpha) of the 8-limb fields below 2^255, shared
// by fields with the same counts: bn254_scalar, grumpkin_scalar and
// bls12_381_scalar (alpha 5), bls12_377_scalar (11), stark252 (3).
#define POSEIDON2_LIMBS(X) \
  X(2, 4, 56, 5)           \
  X(3, 4, 56, 5)           \
  X(4, 4, 56, 5)           \
  X(8, 4, 57, 5)           \
  X(2, 4, 37, 11)          \
  X(3, 4, 37, 11)          \
  X(4, 4, 37, 11)          \
  X(8, 4, 37, 11)          \
  X(2, 4, 83, 3)           \
  X(3, 4, 83, 3)           \
  X(4, 4, 84, 3)           \
  X(8, 4, 84, 3)

// An 8-limb instance: constants in global memory (Poseidon2's device
// arrays), read one uniform element at a time.
template <int T, int HALF, int PARTIAL, int ALPHA>
struct Limbs {
  using F = Limbs8;
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

// Hashes `batch` rows of n 8-limb elements on `stream` without
// synchronising. x, out, rc, diag_m1: device pointers (rc and diag_m1: the
// round constants and d - 1 in Montgomery form). t: the width. consts: host
// array {p[8], one[8], inv32, 0, r2[8]}. tag: a host pointer to the
// Montgomery-form domain tag's 8 words, or null. Built for the
// POSEIDON2_LIMBS counts. Returns the launch's cudaError_t (0 on success).
int icicle_poseidon2_limbs_hash(const void* x, void* out, const void* rc, const void* diag_m1,
                                const unsigned int* tag, long long batch, int n, int t,
                                int half_full, int partial, int alpha,
                                const unsigned int* consts, void* stream) {
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ICICLE_P2_LIMBS_CASE(T, HALF, PARTIAL, ALPHA)                                     \
  if (t == (T) && half_full == (HALF) && partial == (PARTIAL) && alpha == (ALPHA)) {       \
    using I = Limbs<T, HALF, PARTIAL, ALPHA>;                                              \
    I::Args a{};                                                                           \
    a.c = Limbs8::consts(consts);                                                          \
    a.has_tag = tag != nullptr ? 1 : 0;                                                    \
    for (int j = 0; j < 8; ++j) a.tag.v[j] = tag != nullptr ? tag[j] : 0u;                 \
    a.rc = static_cast<const uint32_t*>(rc);                                               \
    a.diag_m1 = static_cast<const uint32_t*>(diag_m1);                                     \
    return launch<I, true>(x, out, batch, n, a, s);                                        \
  }
  POSEIDON2_LIMBS(ICICLE_P2_LIMBS_CASE)
#undef ICICLE_P2_LIMBS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
