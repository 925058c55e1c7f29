// The radix-12 overflow audit's schedule of each G1 curve: which operands
// of each Montgomery multiply of the mixed add (`madd_r12`, 11 multiplies)
// and of the projective add (`padd_r12`, 12) are carry-normalised first,
// in the order msm_scan_r12.py's `_madd_r12` and `_padd_r12` call them.
// The audit (math/radix12.py Radix12.audit_mul, as the JAX package's
// _R12Field.mul) decides from static per-word bounds, so for one field the
// normalisations are fixed; they depend on the field's word count and its
// modulus' top words. A code is bit 0: normalise the first operand, bit 1:
// the second. msm_scan_r12.py's KERNEL_SCHEDULES holds the same tables, and
// tests/test_torch_radix12.py and tests/test_torch_msm_split_r12.py hold
// both to the audit's choices and parse this file.
//
// kCurve is the curve's index, the first word of the kernel's consts
// (msm_scan_r12.py R12_CURVES); kWords its word count NW (msm_scan_r12.py
// r12_engine: the JAX package's, one more on grumpkin and bls12_381).

#pragma once

#include <cstdint>

namespace icicle_r12 {

struct schedule_bn254 {
  static constexpr int kCurve = 0;
  static constexpr int kWords = 22;
  static constexpr unsigned char kMadd[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  static constexpr unsigned char kPadd[12] = {0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 2, 1};
};

struct schedule_grumpkin {
  static constexpr int kCurve = 1;
  static constexpr int kWords = 23;
  static constexpr unsigned char kMadd[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  static constexpr unsigned char kPadd[12] = {0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 2, 1};
};

struct schedule_bls12_377 {
  static constexpr int kCurve = 2;
  static constexpr int kWords = 32;
  static constexpr unsigned char kMadd[11] = {0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0};
  static constexpr unsigned char kPadd[12] = {1, 1, 1, 3, 3, 3, 1, 0, 1, 0, 2, 1};
};

struct schedule_bls12_381 {
  static constexpr int kCurve = 3;
  static constexpr int kWords = 33;
  static constexpr unsigned char kMadd[11] = {0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0};
  static constexpr unsigned char kPadd[12] = {1, 1, 1, 3, 3, 3, 1, 0, 1, 0, 2, 1};
};

struct schedule_bw6_761 {
  static constexpr int kCurve = 4;
  static constexpr int kWords = 64;
  static constexpr unsigned char kMadd[11] = {1, 1, 2, 2, 2, 2, 0, 3, 2, 1, 1};
  static constexpr unsigned char kPadd[12] = {3, 3, 3, 3, 3, 3, 3, 1, 3, 2, 3, 3};
};

// A schedule's codes, two bits a multiply (multiply k at bits 2k, 2k + 1):
// the kernels' template argument.
template <int N>
constexpr uint32_t pack_schedule(const unsigned char (&codes)[N]) {
  uint32_t s = 0;
  for (int k = 0; k < N; ++k) s |= static_cast<uint32_t>(codes[k]) << (2 * k);
  return s;
}

}  // namespace icicle_r12
