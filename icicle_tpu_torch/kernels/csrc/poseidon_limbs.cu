// The 8-limb Poseidon instances (bn254_scalar, grumpkin_scalar,
// bls12_377_scalar, bls12_381_scalar, stark252 at t = 3, 5, 9, 12) on
// NVIDIA Hopper (sm_90a); the kernel and its design are in poseidon.cuh.
// Bound to Python with ctypes (icicle_tpu_torch/kernels/poseidon_kernel.py:
// poseidon).

#include "poseidon.cuh"

namespace {

using namespace icicle_pos;

// (t, half, partial) of the 8-limb fields' constants, shared by fields with
// the same counts: bls12_381_scalar alone has 55 partial rounds at t = 3;
// tests/test_torch_poseidon.py holds this table against the .npz files.
#define POSEIDON_LIMBS(X) \
  X(3, 4, 55)             \
  X(3, 4, 56)             \
  X(5, 4, 56)             \
  X(9, 4, 57)             \
  X(12, 4, 57)

// An 8-limb instance: its table in global memory (Poseidon's device array),
// read one uniform element at a time.
template <int T, int HALF, int PARTIAL>
struct Limbs {
  using F = icicle_p2::Limbs8;
  static constexpr int kT = T, kHalf = HALF, kPartial = PARTIAL;
  struct Args {
    F::C c;
    F::E tag;
    int has_tag;
    const uint32_t* table;
  };
  struct K {
    const uint32_t* p;
    __device__ __forceinline__ F::E get(int i) const { return F::load(p, i); }
  };
  static __device__ __forceinline__ K constants(const Args& a) { return K{a.table}; }
};

}  // namespace

extern "C" {

// Hashes `batch` rows of t - has_tag 8-limb elements on `stream` without
// synchronising. x, out, table: device pointers (table: the instance's
// constants in Montgomery form, poseidon.cuh's Layout). consts: host array
// {p[8], one[8], inv32, 0, r2[8]}. tag: a host pointer to the
// Montgomery-form domain tag's 8 words, or null. Built for the
// POSEIDON_LIMBS counts. Returns the launch's cudaError_t (0 on success).
int icicle_poseidon_limbs_hash(const void* x, void* out, const void* table,
                               const unsigned int* tag, long long batch, int t, int half,
                               int partial, const unsigned int* consts, void* stream) {
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ICICLE_POS_LIMBS_CASE(T, HALF, PARTIAL)                          \
  if (t == (T) && half == (HALF) && partial == (PARTIAL)) {              \
    using I = Limbs<T, HALF, PARTIAL>;                                   \
    I::Args a{};                                                         \
    a.c = icicle_p2::Limbs8::consts(consts);                             \
    a.has_tag = tag != nullptr ? 1 : 0;                                  \
    for (int j = 0; j < 8; ++j) a.tag.v[j] = tag != nullptr ? tag[j] : 0u; \
    a.table = static_cast<const uint32_t*>(table);                       \
    return launch<I>(x, out, batch, a, s);                               \
  }
  POSEIDON_LIMBS(ICICLE_POS_LIMBS_CASE)
#undef ICICLE_POS_LIMBS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
