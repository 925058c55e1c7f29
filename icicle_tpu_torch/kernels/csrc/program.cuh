// The field-program evaluator that the sumcheck kernel (sumcheck.cu, a
// round's combine) and the program kernel (program.cu, execute_program)
// share, over mont32.cuh. Values are in Montgomery form throughout.
//
// A program (icicle_tpu_torch/ops/program.py, the JAX package's
// icicle_tpu/ops/program.py) is either predefined and compiled in:
//   AB_MINUS_C:       out = a b - c                (inputs 0, 1, 2)
//   EQ_X_AB_MINUS_C:  out = e (a b - c)            (inputs 0, 1, 2, e = 3)
// or any other, interpreted from `Program.to_bytecode()`: u32 instructions
// op | in1 << 8 | in2 << 16 | out << 24 over a register file whose slots
// [0, nof_parameters) hold the parameters and whose later slots hold the
// constants (at the slots `Program.constant_slots` gives) and the
// instructions' results; each output is read from its slot
// (`Program.output_slots`), which may be a parameter or a constant slot
// when no instruction computes it. The register file is a thread-local
// array indexed at run time (local memory): the interpreted route serves
// any program of at most kMaxInstr instructions and kMaxSlots slots, the
// predefined ones keep everything in registers.

#pragma once

#include <cstdint>

#include "mont32.cuh"

namespace icicle_prog {

constexpr int kMaxSlots = 64;
constexpr int kMaxInstr = 64;
constexpr int kMaxConsts = 16;
constexpr int kMaxParams = 16;
constexpr int kMaxOutputs = 8;

enum Kind : int { AB_MINUS_C = 0, EQ_X_AB_MINUS_C = 1, BYTECODE = 2 };
enum Opcode : uint32_t { COPY = 0, ADD = 1, MULT = 2, SUB = 3, INV = 4 };

// A program's bytecode, passed by value as a kernel argument (380 bytes).
struct Code {
  int n_instr;
  int n_consts;
  int n_out;
  uint32_t instr[kMaxInstr];
  uint32_t const_val[kMaxConsts];  // Montgomery form
  uint8_t const_slot[kMaxConsts];
  uint8_t out_slot[kMaxOutputs];
};

// Runs the bytecode over `reg`, whose parameter slots the caller filled.
template <class F>
__device__ __forceinline__ void run(const Code& c, uint32_t* reg) {
  for (int i = 0; i < c.n_consts; ++i) reg[c.const_slot[i]] = c.const_val[i];
  for (int i = 0; i < c.n_instr; ++i) {
    const uint32_t w = c.instr[i];
    const uint32_t a = reg[(w >> 8) & 0xFFu];
    const uint32_t b = reg[(w >> 16) & 0xFFu];
    uint32_t r;
    switch (w & 0xFFu) {
      case ADD: r = F::add(a, b); break;
      case MULT: r = F::mul(a, b); break;
      case SUB: r = F::sub(a, b); break;
      case INV: r = F::inv(a); break;
      default: r = a;  // COPY
    }
    reg[w >> 24] = r;
  }
}

// The single output of a combine program over the inputs x[0..n).
template <class F, int KIND, int N>
__device__ __forceinline__ uint32_t combine(const uint32_t (&x)[N], int n, const Code& c) {
  if constexpr (KIND == AB_MINUS_C) {
    return F::sub(F::mul(x[0], x[1]), x[2]);
  } else if constexpr (KIND == EQ_X_AB_MINUS_C) {
    return F::mul(x[3], F::sub(F::mul(x[0], x[1]), x[2]));
  } else {
    uint32_t reg[kMaxSlots];
#pragma unroll
    for (int q = 0; q < N; ++q)
      if (q < n) reg[q] = x[q];
    run<F>(c, reg);
    return reg[c.out_slot[0]];
  }
}

}  // namespace icicle_prog
