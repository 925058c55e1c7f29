// The single-word Poseidon2 instances (babybear, koalabear, m31 at every
// width) on NVIDIA Hopper (sm_90a); the kernel and its design are in
// poseidon2.cuh. Bound to Python with ctypes
// (icicle_tpu_torch/kernels/poseidon2_kernel.py: poseidon2).

#include "poseidon2.cuh"

namespace {

using namespace icicle_p2;

// (field, p, t, half_full, partial, alpha): every width of the three
// single-word fields' constants (ops/hash/data/poseidon2_<field>.npz, their
// t<t>_meta); tests/test_torch_poseidon2_layers.py holds this table
// against those files.
#define POSEIDON2_WORDS(X)                  \
  X(babybear, 0x78000001u, 2, 6, 24, 7)     \
  X(babybear, 0x78000001u, 3, 6, 17, 7)     \
  X(babybear, 0x78000001u, 4, 4, 21, 7)     \
  X(babybear, 0x78000001u, 8, 4, 12, 7)     \
  X(babybear, 0x78000001u, 12, 4, 10, 7)    \
  X(babybear, 0x78000001u, 16, 4, 13, 7)    \
  X(babybear, 0x78000001u, 20, 4, 18, 7)    \
  X(babybear, 0x78000001u, 24, 4, 21, 7)    \
  X(koalabear, 0x7f000001u, 2, 6, 34, 3)    \
  X(koalabear, 0x7f000001u, 3, 6, 24, 3)    \
  X(koalabear, 0x7f000001u, 4, 4, 27, 3)    \
  X(koalabear, 0x7f000001u, 8, 4, 19, 3)    \
  X(koalabear, 0x7f000001u, 12, 4, 20, 3)   \
  X(koalabear, 0x7f000001u, 16, 4, 20, 3)   \
  X(koalabear, 0x7f000001u, 20, 4, 20, 3)   \
  X(koalabear, 0x7f000001u, 24, 4, 23, 3)   \
  X(m31, 0x7fffffffu, 2, 6, 25, 5)          \
  X(m31, 0x7fffffffu, 3, 6, 19, 5)          \
  X(m31, 0x7fffffffu, 4, 4, 22, 5)          \
  X(m31, 0x7fffffffu, 8, 4, 13, 5)          \
  X(m31, 0x7fffffffu, 12, 4, 12, 5)         \
  X(m31, 0x7fffffffu, 16, 4, 14, 5)         \
  X(m31, 0x7fffffffu, 20, 4, 18, 5)         \
  X(m31, 0x7fffffffu, 24, 4, 22, 5)

// A single-word instance: its round constants (every round's, flat, in
// Montgomery form) and d - 1 in __constant__ memory.
#define ICICLE_P2_WORD_INSTANCE(FIELD, P, T, HALF, PARTIAL, ALPHA)                        \
  __constant__ uint32_t FIELD##_t##T##_rc[2 * (HALF) * (T) + (PARTIAL)];                  \
  __constant__ uint32_t FIELD##_t##T##_diag_m1[T];                                        \
  struct FIELD##_t##T {                                                                   \
    using F = Word<P>;                                                                    \
    static constexpr int kT = T, kHalf = HALF, kPartial = PARTIAL, kAlpha = ALPHA;        \
    struct Args {                                                                         \
      F::C c;                                                                             \
      uint32_t tag;                                                                       \
      int has_tag;                                                                        \
    };                                                                                    \
    struct K {                                                                            \
      __device__ __forceinline__ uint32_t rc(int i) const { return FIELD##_t##T##_rc[i]; } \
      __device__ __forceinline__ uint32_t diag_m1(int i) const {                          \
        return FIELD##_t##T##_diag_m1[i];                                                 \
      }                                                                                   \
    };                                                                                    \
    static __device__ __forceinline__ K constants(const Args&) { return K{}; }            \
    static cudaError_t upload(const uint32_t* rc, const uint32_t* diag_m1) {              \
      cudaError_t err = cudaMemcpyToSymbol(FIELD##_t##T##_rc, rc, sizeof(FIELD##_t##T##_rc)); \
      if (err != cudaSuccess) return err;                                                 \
      return cudaMemcpyToSymbol(FIELD##_t##T##_diag_m1, diag_m1,                          \
                                sizeof(FIELD##_t##T##_diag_m1));                          \
    }                                                                                     \
  };
POSEIDON2_WORDS(ICICLE_P2_WORD_INSTANCE)
#undef ICICLE_P2_WORD_INSTANCE

}  // namespace

extern "C" {

// Copies a single-word instance's constants into its __constant__ arrays
// on the current device: rc (2 half_full t + partial words) and diag_m1 (t
// words), host arrays in Montgomery form. p: the field's modulus. Returns a
// cudaError_t (cudaErrorInvalidValue where no instance has these p, t and
// counts).
int icicle_poseidon2_upload(unsigned int p, int t, int half_full, int partial, int alpha,
                            const unsigned int* rc, const unsigned int* diag_m1) {
#define ICICLE_P2_UPLOAD(FIELD, P, T, HALF, PARTIAL, ALPHA)                        \
  if (p == (P) && t == (T)) {                                                      \
    if (half_full != (HALF) || partial != (PARTIAL) || alpha != (ALPHA))           \
      return static_cast<int>(cudaErrorInvalidValue);                              \
    return static_cast<int>(FIELD##_t##T::upload(rc, diag_m1));                    \
  }
  POSEIDON2_WORDS(ICICLE_P2_UPLOAD)
#undef ICICLE_P2_UPLOAD
  return static_cast<int>(cudaErrorInvalidValue);
}

// Hashes `batch` rows of n single-word elements on `stream` without
// synchronising. x, out: device pointers. t: the width. consts: host array
// {p, one, inv32, 0, r2}; the instance is the one with p = consts[0] and
// width t, which must have had icicle_poseidon2_upload on this device, and
// half_full, partial, alpha must be its counts. tag: a host pointer to the
// Montgomery-form domain tag, or null. Built for the POSEIDON2_WORDS
// instances. Returns the launch's cudaError_t (0 on success).
int icicle_poseidon2_hash(const void* x, void* out, const unsigned int* tag, long long batch,
                          int n, int t, int half_full, int partial, int alpha,
                          const unsigned int* consts, void* stream) {
  if (batch < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ICICLE_P2_WORD_CASE(FIELD, P, T, HALF, PARTIAL, ALPHA)                             \
  if (consts[0] == (P) && t == (T)) {                                                      \
    if (half_full != (HALF) || partial != (PARTIAL) || alpha != (ALPHA))                   \
      return static_cast<int>(cudaErrorInvalidValue);                                      \
    using I = FIELD##_t##T;                                                                \
    const I::Args a{I::F::C{}, tag != nullptr ? tag[0] : 0u, tag != nullptr ? 1 : 0};      \
    return n == (T) - a.has_tag ? launch<I, false>(x, out, batch, n, a, s)                 \
                                : launch<I, true>(x, out, batch, n, a, s);                 \
  }
  POSEIDON2_WORDS(ICICLE_P2_WORD_CASE)
#undef ICICLE_P2_WORD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
