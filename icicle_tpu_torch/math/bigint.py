"""Multi-limb modular arithmetic on int32 limb tensors (counterpart of
icicle_tpu/math/bigint.py `BigField`).

Storage: an element is a `(..., L)` `torch.int32` tensor holding the
little-endian uint32 limb **bit patterns** of its canonical value in [0, p).
A limb >= 2^31 is negative in int32; the CUDA kernels read the same bits as
`uint32_t`. Arithmetic widens each limb with `x.to(torch.int64) & 0xFFFFFFFF`
and narrows back with a wrapping cast; nothing here computes on
`torch.uint32` (CPU torch lacks add, `>>` and `<` on it). Every op returns
canonical limbs, so any correct route to a result is bit-equal to the JAX
engine's (`_mont_fused16`, whose output is canonical too).

Products use 16-bit half-limbs, so that each partial product (< 2^32) and
each column sum (< 2^38 for L <= 16) fits int64. A schoolbook product is
one outer product and one anti-diagonal sum. The Montgomery reduction
(R = 2^(32 L)) is separated operand scanning: m = (T mod R) p' mod R and
(T + m p) / R, three such products. Carries are resolved by carry-lookahead
on bit masks, a fixed handful of ops for any limb count up to 31 (a loop
over the limbs beyond that), so an op costs about a hundred torch calls
whatever L: the plain versions of the MSM kernels call this engine 13
times per slot.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from icicle_tpu_torch.math.params import FieldParams, limbs_of

I32 = torch.int32
I64 = torch.int64
MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 limb bit patterns -> int64 limb values in [0, 2^32)."""
    return x.to(I64) & MASK32


def narrow(v: torch.Tensor) -> torch.Tensor:
    """int64 limb values in [0, 2^32) -> int32 bit patterns (wrapping cast)."""
    return v.to(I32)


def carry_resolve(v: torch.Tensor, bits: int):
    """Resolve signed int64 columns `v` (..., n), worth sum v_k 2^(bits k),
    into digits in [0, 2^bits) and the (signed) carry out of the top column,
    one column at a time. `>>` on int64 is arithmetic, so a negative column
    borrows."""
    mask = (1 << bits) - 1
    out = torch.empty_like(v)
    carry = None
    for k in range(v.shape[-1]):
        x = v[..., k] if carry is None else v[..., k] + carry
        out[..., k] = x & mask
        carry = x >> bits
    return out, carry


_LOOKAHEAD_COLUMNS = 62  # carries travel as bits of one int64


def _normalize(v: torch.Tensor, bits: int, carry_in: int = 0):
    """Columns v (..., n), each in [0, 2^(bits+1) - 1), plus `carry_in`
    (0 or 1) into column 0 -> digits in [0, 2^bits) and the carry out of the
    top column (0 or 1).

    Carry-lookahead in a few ops, whatever n: column k generates a carry
    when v_k >= 2^bits and propagates one when its digit is all ones. With
    those as the bits of G and P, the carries are the carries of the binary
    sum (G | P) + G + carry_in."""
    n = v.shape[-1]
    if n > _LOOKAHEAD_COLUMNS:
        if carry_in:
            v = v.clone()
            v[..., 0] += carry_in
        return carry_resolve(v, bits)
    mask = (1 << bits) - 1
    weights = 1 << torch.arange(n, dtype=I64, device=v.device)
    d = v & mask
    g = ((v >> bits) * weights).sum(-1)
    x = g | ((d == mask).to(I64) * weights).sum(-1)
    total = x + g + carry_in
    carries = ((total ^ x ^ g).unsqueeze(-1) >> torch.arange(n, device=v.device)) & 1
    return (d + carries) & mask, (total >> n) & 1


def _settle(v: torch.Tensor, bits: int, rounds: int = 2) -> torch.Tensor:
    """Move each column's excess above 2^bits into the next column, `rounds`
    times; the top column's excess is dropped (the caller reduces mod
    2^(bits n) or leaves a free top column). Two rounds take columns below
    2^40 (at 16-bit digits) into `_normalize`'s range."""
    mask = (1 << bits) - 1
    for _ in range(rounds):
        v = (v & mask) + F.pad((v >> bits)[..., :-1], (1, 0))
    return v


def _antidiagonal_sums(prod: torch.Tensor) -> torch.Tensor:
    """(..., n, n) -> (..., 2n-1): column k is the sum of prod[..., i, k-i].

    Padding each row to 2n and re-reading the flat buffer with row stride
    2n-1 shifts row i right by i, so the column sum is one `sum`."""
    n = prod.shape[-1]
    batch = prod.shape[:-2]
    flat = F.pad(prod, (0, n)).reshape(*batch, 2 * n * n)[..., :n * (2 * n - 1)]
    return flat.reshape(*batch, n, 2 * n - 1).sum(-2)


def _product_columns(a16: torch.Tensor, b16: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of half-limb vectors as column sums (..., 2n-1)."""
    return _antidiagonal_sums(a16.unsqueeze(-1) * b16.unsqueeze(-2))


class BigField:
    """Montgomery arithmetic for a fixed multi-limb prime field."""

    def __init__(self, params: FieldParams):
        self.params = params
        self.p_int = params.modulus
        self.nlimbs = params.nlimbs
        self.nh = params.nhalf  # number of 16-bit half-limbs
        self._tables: dict = {}

    # -- constants -----------------------------------------------------------
    def _table(self, key: str, values, device) -> torch.Tensor:
        t = self._tables.get((key, device))
        if t is None:
            t = torch.tensor(values, dtype=I64, device=device)
            self._tables[(key, device)] = t
        return t

    def _p32(self, device) -> torch.Tensor:
        return self._table("p32", limbs_of(self.p_int, self.nlimbs), device)

    def _p16(self, device) -> torch.Tensor:
        return self._table("p16", limbs_of(self.p_int, self.nh, 16), device)

    def _pinv16(self, device) -> torch.Tensor:
        """p' = -p^-1 mod R as half-limbs."""
        r = 1 << (32 * self.nlimbs)
        return self._table("pinv16", limbs_of((-pow(self.p_int, -1, r)) % r, self.nh, 16),
                           device)

    def const(self, value: int, like: torch.Tensor | None = None,
              device=None) -> torch.Tensor:
        """A Python int as an int32 (L,) limb tensor, broadcast to `like`'s
        batch shape and device when given."""
        dev = like.device if like is not None else device
        limbs = limbs_of(value % self.p_int, self.nlimbs)
        arr = narrow(torch.tensor(limbs, dtype=I64, device=dev))
        if like is not None:
            arr = arr.expand(like.shape[:-1] + (self.nlimbs,))
        return arr

    # -- add/sub ---------------------------------------------------------------
    def _reduce_once(self, s: torch.Tensor, over: torch.Tensor) -> torch.Tensor:
        """s (..., L) int64 limbs plus an overflow bit `over` (s + over R
        < 2p) -> s mod p as int32 limbs."""
        d, no_borrow = _normalize(s + (MASK32 - self._p32(s.device)), 32, carry_in=1)
        use_d = (over > 0) | (no_borrow > 0)
        return narrow(torch.where(use_d.unsqueeze(-1), d, s))

    def add(self, a, b):
        s, carry = _normalize(widen(a) + widen(b), 32)
        return self._reduce_once(s, carry)

    def sub(self, a, b):
        # a - b = a + ~b + 1 - R: no carry out means a borrow
        d, no_borrow = _normalize(widen(a) + (MASK32 - widen(b)), 32, carry_in=1)
        dp, _ = _normalize(d + self._p32(d.device), 32)
        return narrow(torch.where((no_borrow == 0).unsqueeze(-1), dp, d))

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def is_zero(self, a):
        return (a == 0).all(-1)

    def eq(self, a, b):
        return (a == b).all(-1)

    # -- multiplication --------------------------------------------------------
    def _split16(self, a: torch.Tensor) -> torch.Tensor:
        """(..., L) int32 limbs -> (..., 2L) int64 half-limbs, low half first."""
        w = widen(a)
        return torch.stack([w & MASK16, w >> 16], dim=-1).reshape(
            a.shape[:-1] + (self.nh,))

    def mul_mont(self, a, b):
        """a * b * R^-1 mod p, R = 2^(32 L); canonical limbs out. The
        operands may be any values whose product is below p R (T + m p
        < 2 p R, so one conditional subtract suffices): canonical ones, or
        one in [0, 4p) with the other canonical where 4p <= R, as the r12
        engine's values in [0, 4p) are (bn254: 4p < 2^256)."""
        nh = self.nh
        a16, b16 = torch.broadcast_tensors(self._split16(a), self._split16(b))
        t, _ = _normalize(_settle(F.pad(_product_columns(a16, b16), (0, 1)), 16), 16)
        m, _ = _normalize(_settle(  # T p' mod R: the top excess drops out
            _product_columns(t[..., :nh], self._pinv16(t.device))[..., :nh], 16), 16)
        s = t + F.pad(_product_columns(m, self._p16(t.device)), (0, 1))
        s, _ = _normalize(_settle(F.pad(s, (0, 1)), 16), 16)  # T + m p < 2pR
        hi = s[..., nh:2 * nh]                                # (T + m p) / R
        return self._reduce_once(hi[..., 0::2] | (hi[..., 1::2] << 16), s[..., 2 * nh])

    def div_pow2(self, a, d: int):
        """a * 2^-d mod p, canonical, for 0 <= d < 32 and limbs a < 4p (and
        < R): the value mul_mont(a, 2^(32 L - d)) gives, for a few torch ops
        instead of three products. k = -a p^-1 mod 2^d makes a + k p a
        multiple of 2^d; (a + k p) / 2^d < (2^d + 3) p / 2^d, then
        conditional subtracts of p."""
        p32 = self._p32(a.device)
        t = widen(a)
        if d:
            low = (1 << d) - 1
            k = ((t[..., :1] & low) * ((-pow(self.p_int, -1, 1 << d)) & low)) & low
            s, _ = _normalize(_settle(F.pad(t + k * p32, (0, 1)), 32), 32)
            t = (s[..., :-1] >> d) | ((s[..., 1:] << (32 - d)) & MASK32)
        for _ in range(-(-((1 << d) + 3) >> d) - 1):
            t = widen(self._reduce_once(t, torch.zeros_like(t[..., 0])))
        return narrow(t)

    def to_mont(self, a):
        return self.mul_mont(a, self.const(self.params.r2, like=a))

    def from_mont(self, a):
        return self.mul_mont(a, self.const(1, like=a))

    def mul(self, a, b):
        """Canonical modular multiply (two REDC passes)."""
        return self.mul_mont(self.mul_mont(a, b),
                             self.const(self.params.r2, device=a.device))

    def sqr(self, a):
        return self.mul(a, a)

    # -- exponentiation / inversion ----------------------------------------------
    def pow_const(self, a, e: int):
        """a^e for a fixed Python-int exponent, left-to-right square and
        multiply in the Montgomery domain; canonical in and out; a^0 = 1."""
        if e == 0:
            return self.const(1, like=a).clone()
        base = self.to_mont(a)
        res = self.const(self.params.r, like=base)  # 1 in Montgomery form
        for bit in bin(e)[2:]:
            res = self.mul_mont(res, res)
            if bit == "1":
                res = self.mul_mont(res, base)
        return self.from_mont(res)

    def inv(self, a):
        """Fermat inverse a^(p-2); maps 0 -> 0."""
        return self.pow_const(a, self.p_int - 2)
