"""Goldilocks field (p = 2^64 - 2^32 + 1) arithmetic on int32 limb pairs
(counterpart of icicle_tpu/math/gl64.py `Goldilocks`).

Storage: an element is a `(..., 2)` `torch.int32` tensor holding the uint32
bit patterns [lo, hi] of its canonical value in [0, p): the JAX package's
`(..., 2)` uint32 layout and the port's multi-limb convention
(math/bigint.py), so `interop.elements_from_numpy` is a view and a CUDA
kernel reads the pair as one `uint64`. Arithmetic widens each word with
`x.to(torch.int64) & 0xFFFFFFFF` and narrows back with a wrapping cast;
nothing computes on `torch.uint32` (CPU torch lacks add, `>>` and `<` on
it), and a 32 x 32-bit product, which can overflow int64's sign, is built
from 16-bit halves.

Reduction uses 2^64 = eps and 2^96 = -1 (mod p), eps = 2^32 - 1, step for
step as the JAX engine's `_reduce128`. No Montgomery domain: `mul_mont` is
`mul` and `to_mont` / `from_mont` are identities, so code written for the
Montgomery fields (twiddles "in Montgomery form") serves goldilocks
unchanged. Every op returns canonical words, so any correct route is
bit-equal to the JAX engine.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from icicle_tpu_torch.math.bigint import _normalize, _product_columns, _settle
from icicle_tpu_torch.math.params import FieldParams

I32 = torch.int32
I64 = torch.int64
MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF
P_LO = 0x00000001
P_HI = 0xFFFFFFFF
EPS = 0xFFFFFFFF  # 2^64 mod p

GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1


def _split(a: torch.Tensor):
    """(..., 2) int32 bit patterns -> (lo, hi) int64 words in [0, 2^32)."""
    w = a.to(I64) & MASK32
    return w[..., 0], w[..., 1]


def _join(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) -> (..., 2) int32 bit patterns (wrapping cast)."""
    return torch.stack(torch.broadcast_tensors(lo, hi), dim=-1).to(I32)


def _add64(alo, ahi, blo, bhi):
    """(lo, hi, carry) of the 64-bit sum a + b; words in [0, 2^32)."""
    lo = alo + blo
    hi = ahi + bhi + (lo >> 32)
    return lo & MASK32, hi & MASK32, hi >> 32


def _sub64(alo, ahi, blo, bhi):
    """(lo, hi, borrow) of the 64-bit difference a - b mod 2^64. `>>` on
    int64 is arithmetic: a negative word shifts to -1, the borrow."""
    lo = alo - blo
    hi = ahi - bhi + (lo >> 32)
    return lo & MASK32, hi & MASK32, -(hi >> 32)


def _canon(lo, hi):
    """A value below 2^64 into [0, p): one conditional subtract of p, which
    only a value with hi = 2^32 - 1 and lo >= 1 needs."""
    ge = (hi == P_HI) & (lo >= P_LO)
    return torch.where(ge, lo - P_LO, lo), torch.where(ge, hi - P_HI, hi)


def _mul128(alo, ahi, blo, bhi):
    """The 128-bit product of two 64-bit values as four words n0..n3: the
    schoolbook product of 16-bit halves (each partial product < 2^32, each
    column sum < 2^34), carried into 16-bit digits."""
    a16 = torch.stack([alo & MASK16, alo >> 16, ahi & MASK16, ahi >> 16], dim=-1)
    b16 = torch.stack([blo & MASK16, blo >> 16, bhi & MASK16, bhi >> 16], dim=-1)
    a16, b16 = torch.broadcast_tensors(a16, b16)
    digits, _ = _normalize(_settle(F.pad(_product_columns(a16, b16), (0, 1)), 16), 16)
    words = digits[..., 0::2] | (digits[..., 1::2] << 16)
    return words.unbind(-1)


def _reduce128(n0, n1, n2, n3):
    """n3 2^96 + n2 2^64 + n1 2^32 + n0 into [0, p) (JAX gl64.py `_reduce128`)."""
    zero = torch.zeros_like(n3)
    # t = (n1, n0) - n3; a borrow added 2^64 = eps, so take eps back (t >= eps)
    tlo, thi, borrow = _sub64(n0, n1, n3, zero)
    blo, bhi, _ = _sub64(tlo, thi, EPS, zero)
    tlo = torch.where(borrow > 0, blo, tlo)
    thi = torch.where(borrow > 0, bhi, thi)
    # t += n2 eps = (n2 << 32) - n2, below 2^64
    elo = (-n2) & MASK32
    ehi = n2 - (n2 != 0).to(I64)
    rlo, rhi, carry = _add64(tlo, thi, elo, ehi)
    # a carry out of 2^64 is eps once more, and cannot carry again
    alo, ahi, _ = _add64(rlo, rhi, EPS, zero)
    rlo = torch.where(carry > 0, alo, rlo)
    rhi = torch.where(carry > 0, ahi, rhi)
    return _canon(rlo, rhi)


class Goldilocks:
    """Elementwise goldilocks arithmetic; the interface of Mont32 and
    BigField."""

    def __init__(self, params: FieldParams):
        assert params.modulus == GOLDILOCKS_P
        self.params = params
        self.p_int = GOLDILOCKS_P

    def add(self, a, b):
        alo, ahi = _split(a)
        blo, bhi = _split(b)
        lo, hi, carry = _add64(alo, ahi, blo, bhi)
        # a carry is 2^64 = eps: add eps, which cannot carry again
        clo, chi, _ = _add64(lo, hi, EPS, torch.zeros_like(hi))
        lo = torch.where(carry > 0, clo, lo)
        hi = torch.where(carry > 0, chi, hi)
        return _join(*_canon(lo, hi))

    def sub(self, a, b):
        alo, ahi = _split(a)
        blo, bhi = _split(b)
        lo, hi, borrow = _sub64(alo, ahi, blo, bhi)
        plo, phi, _ = _add64(lo, hi, P_LO, P_HI)
        return _join(torch.where(borrow > 0, plo, lo), torch.where(borrow > 0, phi, hi))

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b):
        alo, ahi = _split(a)
        blo, bhi = _split(b)
        return _join(*_reduce128(*_mul128(alo, ahi, blo, bhi)))

    # No Montgomery domain: mul_mont is mul and the conversions are no-ops.
    mul_mont = mul

    def to_mont(self, a):
        return a

    def from_mont(self, a):
        return a

    def sqr(self, a):
        return self.mul(a, a)

    def is_zero(self, a):
        return (a == 0).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1)

    def const(self, value: int, like: torch.Tensor | None = None,
              device=None) -> torch.Tensor:
        """A Python int as a (2,) int32 word pair, broadcast to `like`'s batch
        shape and device when given."""
        v = value % self.p_int
        dev = like.device if like is not None else device
        arr = torch.tensor([v & MASK32, v >> 32], dtype=I64, device=dev).to(I32)
        if like is not None:
            arr = arr.expand(like.shape[:-1] + (2,))
        return arr

    def pow_const(self, a, e: int):
        """a^e for a fixed Python-int exponent, left-to-right square and
        multiply; a^0 = 1, 0^0 included, as in the JAX engine."""
        res = self.const(1, like=a).clone()
        for bit in bin(e)[2:] if e else "":
            res = self.mul(res, res)
            if bit == "1":
                res = self.mul(res, a)
        return res

    def inv(self, a):
        """Fermat inverse a^(p-2); maps 0 -> 0."""
        return self.pow_const(a, self.p_int - 2)
