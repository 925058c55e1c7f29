"""Single-word (p < 2^31) field arithmetic on int32 tensors
(counterpart of icicle_tpu/math/mont32.py).

Serves babybear, koalabear and m31. An element is a `torch.int32` holding its
canonical value in [0, p); since p < 2^31 that value is never negative, and
the JAX package's uint32 arrays convert exactly (interop.py). Arithmetic
widens to int64, where a*b < 2^62 fits, and reduces with `%`. Canonical
results are unique, so every function here is bit-equal to its JAX
counterpart whatever the route to the result.

The Montgomery convention is the JAX engine's, R = 2^32:
  * `mul(a, b)`      -- canonical in/out.
  * `mul_mont(a, b)` -- a*b*R^-1; with one operand pre-multiplied by R
                        (twiddles stored in Montgomery form) it takes and
                        gives canonical values.

icicle_tpu/math/u32.py (16x16-bit limb products) has no counterpart: it
exists because the TPU has no widening 32-bit multiply, and both the card
and the CPU have one.
"""

from __future__ import annotations

import torch

from icicle_tpu_torch.math.params import FieldParams

I32 = torch.int32


def _wide(b):
    """b as int64: a 0-dim int64 operand does not promote an int32 tensor
    (torch's promotion skips 0-dim tensors of the same kind), so a 0-dim
    first operand, a program's constant, would leave the product int32."""
    return b.to(torch.int64) if isinstance(b, torch.Tensor) else b


class Mont32:
    """Elementwise modular arithmetic for a fixed single-limb prime field."""

    def __init__(self, params: FieldParams):
        assert params.bits <= 31, "Mont32 requires p < 2^31 so a+b fits in int64 and uint32"
        self.params = params
        self.p = params.modulus
        self.r = params.r                       # R mod p (= 1 in Montgomery form)
        self.r_inv = pow(params.r, -1, self.p)  # R^-1 mod p

    def _mulmod(self, a, b):
        """(a * b) mod p for int32 tensors (or a Python int b) -> int32."""
        return (a.to(torch.int64) * _wide(b) % self.p).to(I32)

    # -- ring ops (canonical representatives in [0, p)) ---------------------
    def add(self, a, b):
        s = a.to(torch.int64) + _wide(b)
        return torch.where(s >= self.p, s - self.p, s).to(I32)

    def sub(self, a, b):
        d = a - b
        return torch.where(d < 0, d + self.p, d)

    def neg(self, a):
        return torch.where(a == 0, a, self.p - a)

    def mul(self, a, b):
        return self._mulmod(a, b)

    def mul_mont(self, a, b):
        return self._mulmod(self._mulmod(a, b), self.r_inv)

    def to_mont(self, a):
        return self._mulmod(a, self.r)

    def from_mont(self, a):
        return self._mulmod(a, self.r_inv)

    def sqr(self, a):
        return self.mul(a, a)

    def pow_const(self, a, e: int):
        """a^e for a fixed Python-int exponent (square-and-multiply);
        a^0 = 1, including 0^0, as in the JAX engine."""
        result = torch.ones_like(a)
        base = a
        while e:
            if e & 1:
                result = self.mul(result, base)
            e >>= 1
            if e:
                base = self.mul(base, base)
        return result

    def inv(self, a):
        """Fermat inverse a^(p-2); inv(0) = 0."""
        return self.pow_const(a, self.p - 2)
