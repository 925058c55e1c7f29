// A field program elementwise over parameter vectors on NVIDIA Hopper
// (sm_90a): kernel K4 of the port. Bound to Python with ctypes
// (icicle_tpu_torch/kernels/program_kernel.py: execute_program_kernel).
//
// No Pallas kernel is replaced: the JAX package's execute_program
// (icicle_tpu/ops/vec_ops.py:258) traces the program (icicle_tpu/ops/
// program.py:149 Program.execute) into XLA, which fuses it; eager torch
// would run each instruction as a pass over the vectors. One thread
// evaluates one element: it reads element i of each parameter vector the
// program reads, takes them into Montgomery form, runs the program
// (program.cuh: AB_MINUS_C and EQ_X_AB_MINUS_C compiled in, any other
// interpreted from its bytecode) and writes each output out of Montgomery
// form to element i of its output vector. The wrapper maps the outputs to
// the parameter slots the JAX package's execute_program gives them.
//
// Bound: the bytes (each parameter the program reads, each output written)
// against the program's Montgomery multiplies and the conversions; a
// predefined program over 2^24 elements is bytes-bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "mont32.cuh"
#include "program.cuh"

namespace {

using icicle_prog::Code;
using icicle_prog::kMaxOutputs;
using icicle_prog::kMaxParams;

constexpr int kThreads = 256;

struct Vectors {
  const uint32_t* in[kMaxParams];  // null where the program reads no such parameter
  uint32_t* out[kMaxOutputs];
};

template <class F, int KIND>
__global__ void __launch_bounds__(kThreads)
    program_kernel(Vectors v, long long n, int nparams, Code code) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= n) return;
  if constexpr (KIND == icicle_prog::BYTECODE) {
    uint32_t reg[icicle_prog::kMaxSlots];
    for (int q = 0; q < nparams; ++q)
      if (v.in[q] != nullptr) reg[q] = F::to_mont(__ldg(v.in[q] + i));
    icicle_prog::run<F>(code, reg);
    for (int k = 0; k < code.n_out; ++k) v.out[k][i] = F::from_mont(reg[code.out_slot[k]]);
  } else {
    constexpr int kIn = KIND == icicle_prog::AB_MINUS_C ? 3 : 4;
    uint32_t x[kIn];
#pragma unroll
    for (int q = 0; q < kIn; ++q) x[q] = F::to_mont(__ldg(v.in[q] + i));
    v.out[0][i] = F::from_mont(icicle_prog::combine<F, KIND>(x, kIn, code));
  }
}

template <class F>
cudaError_t launch(int kind, const Vectors& v, long long n, int nparams, const Code& code,
                   cudaStream_t s) {
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  if (kind == icicle_prog::AB_MINUS_C)
    program_kernel<F, icicle_prog::AB_MINUS_C><<<blocks, kThreads, 0, s>>>(v, n, nparams, code);
  else if (kind == icicle_prog::EQ_X_AB_MINUS_C)
    program_kernel<F, icicle_prog::EQ_X_AB_MINUS_C><<<blocks, kThreads, 0, s>>>(v, n, nparams,
                                                                                 code);
  else if (kind == icicle_prog::BYTECODE)
    program_kernel<F, icicle_prog::BYTECODE><<<blocks, kThreads, 0, s>>>(v, n, nparams, code);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Evaluates the program on `stream` without synchronising. p: the field's
// modulus (an ICICLE_M32_FIELDS entry). in: host array of nparams device
// pointers (null for a parameter the program does not read); out: host
// array of the outputs' device pointers (n_out of the bytecode, or 1 for a
// predefined program). kind: 0 AB_MINUS_C, 1 EQ_X_AB_MINUS_C, 2 the
// bytecode in `code` (a host pointer to a Code). Returns the launch's
// cudaError_t (0 on success).
int icicle_execute_program(unsigned int p, const void* const* in, void* const* out,
                           long long n, int nparams, int kind, const void* code,
                           void* stream) {
  if (n < 1 || nparams < 1 || nparams > kMaxParams) return static_cast<int>(cudaErrorInvalidValue);
  const Code& c = *static_cast<const Code*>(code);
  Vectors v{};
  for (int q = 0; q < nparams; ++q) v.in[q] = static_cast<const uint32_t*>(in[q]);
  const int n_out = kind == icicle_prog::BYTECODE ? c.n_out : 1;
  if (n_out < 1 || n_out > kMaxOutputs) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < n_out; ++k) v.out[k] = static_cast<uint32_t*>(out[k]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ICICLE_PROG_FIELD(NAME, P) \
  if (p == (P)) return static_cast<int>(launch<icicle_m32::Mont32<P>>(kind, v, n, nparams, c, s));
  ICICLE_M32_FIELDS(ICICLE_PROG_FIELD)
#undef ICICLE_PROG_FIELD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
