// The single-word Poseidon instances (babybear, koalabear, m31 at t = 3, 5,
// 9, 12) on NVIDIA Hopper (sm_90a); the kernel and its design are in
// poseidon.cuh. Bound to Python with ctypes
// (icicle_tpu_torch/kernels/poseidon_kernel.py: poseidon).

#include "poseidon.cuh"

namespace {

using namespace icicle_pos;

// (field, p, t, half, partial): every width of the three single-word fields'
// constants (ops/hash/data/poseidon_<field>.npz, their t<t>_meta: full =
// 2 half); tests/test_torch_poseidon.py holds this table against those
// files.
#define POSEIDON_WORDS(X)               \
  X(babybear, 0x78000001u, 3, 6, 7)     \
  X(babybear, 0x78000001u, 5, 4, 11)    \
  X(babybear, 0x78000001u, 9, 4, 12)    \
  X(babybear, 0x78000001u, 12, 4, 12)   \
  X(koalabear, 0x7f000001u, 3, 6, 7)    \
  X(koalabear, 0x7f000001u, 5, 4, 11)   \
  X(koalabear, 0x7f000001u, 9, 4, 12)   \
  X(koalabear, 0x7f000001u, 12, 4, 12)  \
  X(m31, 0x7fffffffu, 3, 6, 7)          \
  X(m31, 0x7fffffffu, 5, 4, 11)         \
  X(m31, 0x7fffffffu, 9, 4, 12)         \
  X(m31, 0x7fffffffu, 12, 4, 12)

// A single-word instance: its constant table in __constant__ memory.
#define ICICLE_POS_WORD_INSTANCE(FIELD, P, T, HALF, PARTIAL)                                \
  __constant__ uint32_t FIELD##_t##T##_table[Layout<T, HALF, PARTIAL>::kSize];              \
  struct FIELD##_t##T {                                                                     \
    using F = Word32<P>;                                                                    \
    static constexpr int kT = T, kHalf = HALF, kPartial = PARTIAL;                          \
    struct Args {                                                                           \
      F::C c;                                                                               \
      uint32_t tag;                                                                         \
      int has_tag;                                                                          \
    };                                                                                      \
    struct K {                                                                              \
      __device__ __forceinline__ uint32_t get(int i) const { return FIELD##_t##T##_table[i]; } \
    };                                                                                      \
    static __device__ __forceinline__ K constants(const Args&) { return K{}; }              \
    static cudaError_t upload(const uint32_t* table) {                                      \
      return cudaMemcpyToSymbol(FIELD##_t##T##_table, table, sizeof(FIELD##_t##T##_table)); \
    }                                                                                       \
  };
POSEIDON_WORDS(ICICLE_POS_WORD_INSTANCE)
#undef ICICLE_POS_WORD_INSTANCE

}  // namespace

extern "C" {

// Copies a single-word instance's constant table (`words` words in
// Montgomery form, a host array; the layout of poseidon.cuh's Layout) into
// its __constant__ array on the current device. p: the field's modulus.
// Returns a cudaError_t (cudaErrorInvalidValue where no instance has these
// p, t and counts or the table's size differs).
int icicle_poseidon_upload(unsigned int p, int t, int half, int partial,
                           const unsigned int* table, long long words) {
#define ICICLE_POS_UPLOAD(FIELD, P, T, HALF, PARTIAL)                             \
  if (p == (P) && t == (T)) {                                                     \
    if (half != (HALF) || partial != (PARTIAL) ||                                 \
        words != Layout<T, HALF, PARTIAL>::kSize)                                 \
      return static_cast<int>(cudaErrorInvalidValue);                             \
    return static_cast<int>(FIELD##_t##T::upload(table));                         \
  }
  POSEIDON_WORDS(ICICLE_POS_UPLOAD)
#undef ICICLE_POS_UPLOAD
  return static_cast<int>(cudaErrorInvalidValue);
}

// Hashes `batch` rows of t - has_tag single-word elements on `stream`
// without synchronising. x, out: device pointers. The instance is the one
// with modulus p and width t, which must have had icicle_poseidon_upload on
// this device; half and partial must be its counts. tag: a host pointer to
// the Montgomery-form domain tag, or null. Returns the launch's cudaError_t
// (0 on success).
int icicle_poseidon_hash(const void* x, void* out, const unsigned int* tag, long long batch,
                         unsigned int p, int t, int half, int partial, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ICICLE_POS_WORD_CASE(FIELD, P, T, HALF, PARTIAL)                                   \
  if (p == (P) && t == (T)) {                                                              \
    if (half != (HALF) || partial != (PARTIAL)) return static_cast<int>(cudaErrorInvalidValue); \
    using I = FIELD##_t##T;                                                                \
    const I::Args a{I::F::C{}, tag != nullptr ? tag[0] : 0u, tag != nullptr ? 1 : 0};      \
    return launch<I>(x, out, batch, a, s);                                                 \
  }
  POSEIDON_WORDS(ICICLE_POS_WORD_CASE)
#undef ICICLE_POS_WORD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
